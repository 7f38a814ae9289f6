"""One shard of the in-memory store (counterpart of
``filodb_tpu/memstore/shard.py``; reference L2: TimeSeriesShard.scala:268 —
ingest loop :939, partition creation :1193, flush pipeline :1273-1636,
eviction :1709-1799, lookup :2097).

A shard owns the partkey -> partition map and the tag index. ``version``
moves on every ingest, and every move records one entry in a bounded
effect log, so a reader holding an older version can prove that a staged
time range was left untouched. The shard's staging cache holds host-staged
blocks of selections; an ingest marks the entries it overlaps dirty, for
the next query to repair by appending (``staging.append_to_block``).

The shard's index is ``config.index_backend``'s (``_make_index``: the
posting-bitmap ``PartKeyIndex`` by default, the C++ core or the set
index), with the opt-in device tier of hot posting bitmaps. The shard
counts its series by shard-key prefix (``cardinality``, with its quotas)
and answers the metadata queries from its index (label names and values,
the label sets of the matching series).

The lifecycle: flush tasks by flush group (``create_flush_task``, which
``store/flush.FlushCoordinator`` persists), the index's end times
(``update_index_end_times``), retention (``evict_for_retention``), the two
tiers of headroom eviction over the evictable queue
(``evict_for_headroom``) and on-demand paging from the column store
(``odp_page_in``). Every eviction, page-in and recovery bumps ``version``
with a full effect and clears the staging cache, paying its ledger
account back; ``evict_hooks`` let the memstore drop the superblocks an
eviction made stale. Append listeners hear each committed ingest.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np

from ..core.filters import ColumnFilter
from ..core.records import RecordBatch, SeriesBatch
from ..core.schemas import ColumnType, Schema
from .cardinality import CardinalityTracker
from .index import PartKeyIndex, SetBasedPartKeyIndex
from .partition import DEFAULT_MAX_CHUNK_SIZE, Chunk, TimeSeriesPartition

NUM_FLUSH_GROUPS = 16  # reference groups-per-shard default


@dataclass
class ShardStats:
    """reference TimeSeriesShardStats (TimeSeriesShard.scala:41-150)."""

    rows_ingested: int = 0
    rows_skipped: int = 0
    partitions_created: int = 0
    partitions_evicted: int = 0
    chunks_flushed: int = 0
    headroom_evictions: int = 0
    bytes_reclaimed: int = 0


@dataclass
class StoreConfig:
    """Per-dataset store tuning (reference store/IngestionConfig.scala)."""

    max_chunk_size: int = DEFAULT_MAX_CHUNK_SIZE
    retention_ms: int = 3 * 24 * 3_600_000
    encode_on_seal: bool = False
    groups_per_shard: int = NUM_FLUSH_GROUPS
    max_partitions: int = 1_000_000
    # "python" (the vectorized posting-bitmap index, the default) |
    # "native" (the C++ posting-list core; raises where g++ fails) | "set"
    # (the set-arithmetic index, the fuzz tests' oracle)
    index_backend: str = "python"
    # opt-in device tier for hot posting bitmaps (index_device.py): an
    # all-equality selector whose matchers are staged resolves as one launch
    # of the postings intersection. Off by default: the index then never
    # touches a device. "python" backend only.
    index_device_postings: bool = False
    index_device_min_hits: int = 16
    index_device_max_bytes: int = 64 << 20
    # the tier's device: None for the card, or "cpu"
    index_device: str | None = None
    # staging-cache byte budget per shard
    stage_cache_bytes: int = 2 << 30
    # resident chunk bytes per shard; past it headroom eviction runs
    # (reference shard-mem-size + ensureHeadroom watermarks)
    max_resident_bytes: int = 8 << 30
    # eviction takes residency down to this share of the budget
    evict_target_fraction: float = 0.75


class EvictablePartIdQueueSet:
    """Dedup FIFO of headroom-eviction candidates (reference
    EvictablePartIdQueueSet.scala). A partition enters when a flush task is
    cut for it or chunks are paged in, and leaves when tier 2 reclaims it
    or retention removes it; a re-offer moves it to the back, so the head
    is the partition flushed longest ago."""

    __slots__ = ("_q",)

    def __init__(self):
        self._q: dict[int, None] = {}  # insertion-ordered dedup set

    def offer(self, part_id: int) -> None:
        self._q.pop(part_id, None)
        self._q[part_id] = None

    def remove(self, part_id: int) -> None:
        self._q.pop(part_id, None)

    def snapshot(self) -> list[int]:
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __contains__(self, part_id: int) -> bool:
        return part_id in self._q


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

    def __setattr__(self, name, value):
        # a change of a cached entry's bytes moves its cache's ledger account
        if name == "nbytes":
            acct, old = self.__dict__.get("_account"), self.__dict__.get("nbytes")
            if acct is not None and old is not None and value != old:
                if value > old:
                    acct.alloc(value - old, count=0)
                else:
                    acct.free(old - value, "replace", count=0)
        object.__setattr__(self, name, value)


def _entry_devices(entry: StageEntry) -> dict:
    """An entry's bytes by device: its host block and its device copy."""
    from ..ops.staging import block_device, staged_nbytes

    out: dict = {}
    for b in (entry.block, entry.dev_block):
        if b is not None:
            dev = block_device(b)
            out[dev] = out.get(dev, 0) + staged_nbytes(b)
    return out


class StageCache(dict):
    """A shard's staging cache (cache key -> ``StageEntry``) that keeps its
    ledger account (kind ``staged_block``) in step: an entry's bytes are
    debited when it is stored, credited when it leaves, and moved when its
    ``nbytes`` changes (a repair, a device copy, a built sidecar)."""

    def __init__(self, name: str):
        super().__init__()
        from ..ledger import LEDGER

        self.account = LEDGER.register(self, "staged_block", walker=StageCache._walk, name=name,
                                       device_walker=StageCache._walk_devices)

    def _walk(self) -> int:
        return sum(sum(_entry_devices(e).values()) for e in list(self.values()))

    def _walk_devices(self) -> dict:
        out: dict = {}
        for e in list(self.values()):
            for dev, n in _entry_devices(e).items():
                out[dev] = out.get(dev, 0) + n
        return out

    def _release(self, entry: StageEntry, reason: str) -> None:
        if entry.__dict__.get("_account") is not None:
            object.__setattr__(entry, "_account", None)
            self.account.free(entry.nbytes, reason)

    def __setitem__(self, key, entry: StageEntry) -> None:
        old = self.get(key)
        if old is not None and old is not entry:
            self._release(old, "replace")
        super().__setitem__(key, entry)
        if entry.__dict__.get("_account") is None:
            object.__setattr__(entry, "_account", self.account)
            self.account.alloc(entry.nbytes)

    def __delitem__(self, key) -> None:
        entry = self[key]
        super().__delitem__(key)
        self._release(entry, "drop")

    _MISSING = object()

    def pop(self, key, default=_MISSING):
        if key not in self:
            if default is StageCache._MISSING:
                raise KeyError(key)
            return default
        entry = super().pop(key)
        self._release(entry, "evict")
        return entry

    def clear(self) -> None:
        for entry in list(self.values()):
            self._release(entry, "invalidate")
        super().clear()


# how many per-version ingest effects a shard keeps: the proof window for
# the insert-time overlap check and superblock revalidation. A reader older
# than the window is treated as if everything changed.
EFFECT_LOG_MAX = 1024


class TimeSeriesShard:
    def __init__(self, dataset: str, shard_num: int, config: StoreConfig | None = None):
        self.dataset = dataset
        self.shard_num = shard_num
        self.config = config or StoreConfig()
        self.index = self._make_index()
        self.cardinality = CardinalityTracker()
        self.partitions: dict[int, TimeSeriesPartition] = {}
        self._by_partkey: dict[bytes, int] = {}
        self._next_part_id = 0
        self.stats = ShardStats()
        self._lock = threading.RLock()
        self._ingested_offset = -1  # stream offset watermark (Kafka analog)
        self.version = 0
        # one (version, lo_ms, hi_ms, full) per version bump
        self._effects: deque = deque(maxlen=EFFECT_LOG_MAX)
        # cache key (filters, start_ms, end_ms, ...) -> StageEntry
        self.stage_cache = StageCache(f"{dataset}/shard-{shard_num}")
        # cb(dataset, shard_num, lo_ms, hi_ms, full) after each committed
        # ingest, outside the lock: wake signals, not truth
        self._append_listeners: list[Callable] = []
        # cb(shard) after an eviction changed resident data, outside the lock
        self.evict_hooks: list[Callable] = []
        # the column store that pages evicted chunks back in (reference
        # OnDemandPagingShard.scala:26); None keeps the shard memory-only
        self.odp_store = None
        self.odp_stats_pages = 0
        self.evictable = EvictablePartIdQueueSet()
        # the index's end-time lifecycle (reference updateIndexWithEndTime,
        # TimeSeriesShard.scala:987-993): part ids marked ended, and each
        # series' newest sample at the previous flush
        self._ended: set[int] = set()
        self._flush_watermark: dict[int, int] = {}
        # partkeys whose flushed chunks tier 2 reclaimed (reference
        # evictedPartKeys, TimeSeriesShard.scala:540)
        self.evicted_keys: set[bytes] = set()
        self._ingests_since_headroom_check = 0
        # residency: the last measurement plus an estimate of bytes since,
        # so the walk over every partition runs only near the budget
        self._resident_last = 0
        self._approx_new_bytes = 0

    # -- index ---------------------------------------------------------------

    def _make_index(self):
        """The index of ``config.index_backend``, with the device tier when
        ``index_device_postings`` asks for it. Unlike the JAX package, a
        native core that does not build raises, and the tier with another
        backend than "python" is a ``ValueError``: the native backend answers
        equality selectors in C++ and never reaches the tier."""
        backend = self.config.index_backend
        if self.config.index_device_postings and backend != "python":
            raise ValueError(f"index_device_postings needs index_backend=\"python\", not "
                             f"{backend!r}: that backend resolves equality selectors outside "
                             f"the bitmap path the device tier serves")
        if backend == "python":
            idx = PartKeyIndex()
        elif backend == "native":
            from .index_native import NativePartKeyIndex

            return NativePartKeyIndex()
        elif backend == "set":
            return SetBasedPartKeyIndex()
        else:
            raise ValueError(f"unknown index_backend {backend!r} (python, native or set)")
        if self.config.index_device_postings:
            from .index_device import DevicePostingsTier

            idx.device_tier = DevicePostingsTier(
                idx, self.config.index_device or "cuda",
                min_hits=self.config.index_device_min_hits,
                max_bytes=self.config.index_device_max_bytes,
                name=f"{self.dataset}/shard-{self.shard_num}/index",
            )
        return idx

    def index_stats(self) -> dict:
        """Introspection for /debug/index and the filodb_index_* gauges (the
        set backend reports a minimal shape)."""
        if hasattr(self.index, "postings_stats"):
            return self.index.postings_stats()
        return {"num_part_keys": len(self.index), "labels": {},
                "postings_bytes": 0, "dictionary_size": 0, "device": None}

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

    def ingest_effects_interval_since(self, since_version: int, lo: int, hi: int):
        """``ingest_effects_since`` with the union interval of the
        overlapping effects: ``(reason, eff_lo, eff_hi)``, the bounds None
        unless reason is ``"overlap"``. The standing maintainer bounds by it
        the retained steps an append can have touched (only the suffix
        whose windows reach ``eff_lo``)."""
        with self._lock:
            return self._ingest_effects_interval_locked(since_version, lo, hi)

    def _ingest_effects_interval_locked(self, since_version: int, lo, hi):
        """The one effect-log scan behind both forms, so staging and the
        standing path never disagree on what counts as covered:
        ``(reason, eff_lo, eff_hi)``, with the union interval of the
        overlapping effects when reason is ``"overlap"``."""
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

    # -- append notification -------------------------------------------------

    def add_append_listener(self, cb: Callable) -> None:
        """Register ``cb(dataset, shard_num, lo_ms, hi_ms, full)``, called
        after each ingest commits, outside the shard lock (a listener that
        re-enters the shard would deadlock under it). A wake signal: the
        effect log stays the truth, so a lost call is harmless."""
        self._append_listeners.append(cb)

    def remove_append_listener(self, cb: Callable) -> None:
        try:
            self._append_listeners.remove(cb)
        except ValueError:
            pass

    def _notify_append(self, lo, hi, full: bool) -> None:
        for cb in list(self._append_listeners):
            try:
                cb(self.dataset, self.shard_num, lo, hi, full)
            except Exception:  # noqa: BLE001 -- a sick listener must not break ingest
                pass

    def _notify_evicted(self) -> None:
        for cb in list(self.evict_hooks):
            cb(self)

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

    def ingest(self, batch: RecordBatch, offset: int = -1) -> int:
        """Ingest a columnar record batch as one version bump (reference
        ingest:939): records are grouped by series and appended in bulk.
        ``offset`` moves the stream watermark a flush checkpoints. Returns
        the number of rows ingested."""
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
            if offset >= 0:
                self._ingested_offset = max(self._ingested_offset, offset)
            self.version += 1
            new_series = len(self.partitions) != np0
            self._invalidate_stage_range(min_ts, max_ts, new_series, raw_lo=raw_min)
        if n and self._append_listeners:
            self._notify_append(min_ts, max_ts, new_series or min_ts is None)
        self.stats.rows_ingested += n
        # the headroom check of the ingest path (reference ensureFreeSpace):
        # the walk runs only when the estimate could be over budget
        self._approx_new_bytes += n * 24  # ts 8 + value 8 + slack
        self._ingests_since_headroom_check += 1
        if self._ingests_since_headroom_check >= 64:
            self._ingests_since_headroom_check = 0
            if self._resident_last + self._approx_new_bytes > self.config.max_resident_bytes:
                self.evict_for_headroom()
        return n

    def ingest_series(self, sb: SeriesBatch) -> int:
        """Append one series' samples, creating its partition on first
        sight, as one version bump. Returns the number of rows ingested."""
        lo = hi = None
        full = True
        with self._lock:
            self.version += 1
            np0 = len(self.partitions)
            prev_end = self._prev_end_of(sb.partkey)
            n = self._ingest_series(sb)
            if len(sb.timestamps):
                raw = int(sb.timestamps.min())
                lo = raw if prev_end is None else min(raw, prev_end)
                hi = int(sb.timestamps.max())
                acc = raw if prev_end is None else max(raw, prev_end + 1)
                full = len(self.partitions) != np0
                self._invalidate_stage_range(lo, hi, full, raw_lo=acc)
            else:
                self._record_effect(0, 0, True)
                self._clear_stage_cache()
        if n and self._append_listeners:
            self._notify_append(lo, hi, full)
        return n

    def _ingest_series(self, sb: SeriesBatch) -> int:
        pk = sb.partkey
        pid = self._by_partkey.get(pk)
        if pid is None:
            start = int(sb.timestamps.min()) if len(sb.timestamps) else 0
            pid = self._create_partition(sb.tags, sb.schema, pk, sb.bucket_les, start_ts=start)
        elif pid in self._ended:
            # the series ingests again: back to the still-ingesting sentinel
            self.index.update_end_time(pid, 2**62)
            self._ended.discard(pid)
        ts = sb.timestamps
        values = sb.values
        if len(ts) > 1 and not (np.diff(ts) >= 0).all():
            order = np.argsort(ts, kind="stable")
            ts = ts[order]
            values = {k: v[order] for k, v in values.items()}
        got = self.partitions[pid].ingest(ts, values)
        self.stats.rows_skipped += len(ts) - got
        return got

    def _create_partition(self, tags: Mapping[str, str], schema: Schema, pk: bytes,
                          bucket_les=None, start_ts: int = 0, end_ts: int = 2**62) -> int:
        """reference createNewPartition:1193, the index's addPartKey and the
        cardinality count (its quota raises before anything changes).
        ``end_ts`` below the sentinel indexes the series as ended (recovery
        passes the persisted end time)."""
        if len(self.partitions) >= self.config.max_partitions:
            raise MemoryError(f"shard {self.shard_num}: partition limit reached")
        self.cardinality.series_created(tags)
        pid = self._next_part_id
        self._next_part_id += 1
        self.partitions[pid] = TimeSeriesPartition(
            pid, tags, schema, pk, max_chunk_size=self.config.max_chunk_size,
            encode_on_seal=self.config.encode_on_seal, bucket_les=bucket_les,
        )
        self._by_partkey[pk] = pid
        self.index.add_partkey(pid, dict(tags), start_ts=start_ts, end_ts=end_ts)
        if end_ts < 2**62:
            self._ended.add(pid)
        self.stats.partitions_created += 1
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

    # -- flush / eviction ------------------------------------------------------

    def flush_group_of(self, part_id: int) -> int:
        """Partitions flush in groups, round robin (reference
        prepareFlushGroup:1273: group = partId % groups)."""
        return part_id % self.config.groups_per_shard

    def create_flush_task(self, group: int) -> list:
        """``(partition, chunks)`` of one flush group's sealed chunks not
        yet flushed, each write buffer sealed first (doFlushSteps:1462);
        the store layer persists them, then calls ``mark_flushed``."""
        out = []
        groups = self.config.groups_per_shard
        with self._lock:
            for pid, part in self.partitions.items():
                if pid % groups != group:
                    continue
                part.switch_buffers()
                chunks = part.unflushed_chunks()
                if chunks:
                    out.append((part, chunks))
                    self.evictable.offer(pid)  # reclaimable once persisted
        return out

    def update_index_end_times(self) -> int:
        """Give the series that stopped ingesting a real end time in the
        index (reference updateIndexWithEndTime,
        TimeSeriesShard.scala:987-993): a series whose newest sample did not
        move since the previous flush is ended. Called once a flush cycle;
        returns the series newly ended."""
        n = 0
        with self._lock:
            for pid, part in self.partitions.items():
                if pid in self._ended:
                    continue
                latest = part.latest_ts()
                if latest <= -(2**61):
                    continue  # never ingested
                if self._flush_watermark.get(pid) == latest:
                    self.index.update_end_time(pid, latest)
                    self._ended.add(pid)
                    n += 1
                else:
                    self._flush_watermark[pid] = latest
        return n

    def _changed_in_place(self) -> None:
        """Resident data moved under the caches: bump the version with a
        full effect and clear the staging cache (caller holds the lock)."""
        self.version += 1
        self._record_effect(0, 0, True)
        self._clear_stage_cache()

    def evict_for_retention(self, now_ms: int | None = None) -> int:
        """Drop the chunks older than retention and remove the partitions
        left empty (reference evictPartitions:1709). An empty partition
        stays, as a shell the index routes to on-demand paging, while a
        column store is attached and its last sample lies within retention.
        Returns the samples dropped."""
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        cutoff = now_ms - self.config.retention_ms
        dropped = 0
        dead: list[int] = []
        with self._lock:
            for pid, part in self.partitions.items():
                dropped += part.evict_before(cutoff)
                if part.num_samples() != 0:
                    continue
                if self.odp_store is None or self.index.end_time(pid) < cutoff:
                    dead.append(pid)
            for pid in dead:
                part = self.partitions.pop(pid)
                self._by_partkey.pop(part.partkey, None)
                self.index.remove([pid])
                self.cardinality.series_removed(part.tags)
                self._ended.discard(pid)
                self._flush_watermark.pop(pid, None)
                self.evicted_keys.discard(part.partkey)
                self.evictable.remove(pid)
                self.stats.partitions_evicted += 1
            if dropped or dead:
                self._changed_in_place()
        if dropped or dead:
            self._notify_evicted()
        return dropped

    def add_exemplar(self, partkey: bytes, ts_ms: int, value: float, labels) -> bool:
        """Attach an exemplar to an existing series; False when there is no
        such series (exemplars never create one)."""
        with self._lock:
            pid = self._by_partkey.get(partkey)
            if pid is None:
                return False
            self.partitions[pid].add_exemplar(ts_ms, value, labels)
            return True

    def resident_bytes(self) -> int:
        """Host bytes of every series' data in this shard."""
        with self._lock:
            return sum(p.resident_bytes() for p in self.partitions.values())

    def evict_for_headroom(self, target_bytes: int | None = None) -> int:
        """Reclaim chunk memory until residency is under the watermark
        (reference evictForHeadroom, TimeSeriesShard.scala:1799), walking
        the evictable queue from its head: tier 1 drops the decoded arrays
        of flushed chunks (their encoded form stays readable); tier 2, only
        with a column store attached, drops flushed chunks outright for
        on-demand paging to bring back. Unflushed data is never dropped.
        Returns the bytes freed."""
        budget = self.config.max_resident_bytes
        resident = self.resident_bytes()
        self._resident_last = resident
        self._approx_new_bytes = 0
        if target_bytes is None:
            if resident <= budget:
                return 0
            target = int(budget * self.config.evict_target_fraction)
        else:
            target = target_bytes
            if resident <= target:
                return 0
        freed = 0
        with self._lock:
            cands = [self.partitions[pid] for pid in self.evictable.snapshot()
                     if pid in self.partitions]
            for part in cands:
                if resident - freed <= target:
                    break
                freed += part.drop_decoded_flushed()
            if resident - freed > target and self.odp_store is not None:
                for part in cands:
                    if resident - freed <= target:
                        break
                    got = part.drop_flushed_chunks()
                    if got:
                        freed += got
                        self.evicted_keys.add(part.partkey)
                        self.evictable.remove(part.part_id)  # back at its next flush
            if freed:
                self._resident_last = resident - freed
                self._changed_in_place()
                self.stats.headroom_evictions += 1
                self.stats.bytes_reclaimed += freed
        if freed:
            self._notify_evicted()
        return freed

    def odp_page_in(self, part_ids, start_ms: int, end_ms: int) -> int:
        """Page persisted chunks of ``part_ids`` back in where the query
        starts before what is resident (reference scanPartitions' paging,
        OnDemandPagingShard.scala:147), reading only those series' frames in
        the range (``read_chunks_selective``). Returns the chunks paged in."""
        if self.odp_store is None:
            return 0
        from ..core.encodings import decode_many
        from ..core.schemas import canonical_partkey
        from ..store.columnstore import gc_paused

        need: dict[bytes, TimeSeriesPartition] = {}
        for pid in part_ids:
            part = self.partitions.get(int(pid))
            if part is not None and part.earliest_ts() > start_ms:
                need[part.partkey] = part
        if not need:
            return 0
        n = 0
        # a frame's tags are its partition's, in the same order (one dict
        # wrote both): matched by their items, no partkey built a frame
        by_items = {tuple(p.tags.items()): p for p in need.values()}
        with self._lock, gc_paused():
            frames = []
            resident: dict[int, set] = {}
            for header, _, encs in self.odp_store.read_chunks_selective(
                    self.dataset, self.shard_num, list(need), start_ms, end_ms):
                part = by_items.get(tuple(header["tags"].items()))
                if part is None:
                    part = need.get(canonical_partkey(header["tags"]))
                if part is None:
                    continue
                starts = resident.get(part.part_id)
                if starts is None:
                    starts = resident[part.part_id] = {c.start_ts for c in part.chunks}
                if header["start"] in starts:
                    continue  # already resident
                starts.add(header["start"])
                frames.append((part, header, encs))
            # every frame's columns decoded together
            arrays = iter(decode_many([e for _, _, encs in frames for e in encs]))
            for part, header, encs in frames:
                encoded = dict(zip(header["cols"], encs))
                decoded = {name: as_column(part.schema, name, next(arrays)) for name in encoded}
                part.chunks.append(Chunk(header["start"], header["end"], header["n"], decoded,
                                         encoded))
                part.mark_flushed(header["end"])
                n += 1
            for part in need.values():
                part.chunks.sort(key=lambda c: c.start_ts)
                if n:
                    from ..store.flush import _reconcile_chunks

                    _reconcile_chunks(part)
                self.evictable.offer(part.part_id)  # paged in: evictable again
            if n:
                self._changed_in_place()
                self.odp_stats_pages += n
        return n

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    @property
    def ingested_offset(self) -> int:
        return self._ingested_offset


def as_column(schema: Schema, name: str, a: np.ndarray) -> np.ndarray:
    """A decoded column as the partition holds it: a DOUBLE column as
    float64 (an integral run travels as int64)."""
    try:
        is_double = schema.column(name).ctype == ColumnType.DOUBLE
    except KeyError:
        is_double = False
    return a.astype(np.float64, copy=False) if is_double else a
