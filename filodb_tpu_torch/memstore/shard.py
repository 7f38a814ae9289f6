"""One shard of the in-memory store (counterpart of
``filodb_tpu/memstore/shard.py``; reference L2: TimeSeriesShard.scala:268 —
partition creation :1193, lookup :2097).

A shard owns the partkey -> partition map and the tag index. ``version``
moves on every ingest so a reader can tell whether the shard changed.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.filters import ColumnFilter
from ..core.records import SeriesBatch
from .index import SetBasedPartKeyIndex
from .partition import DEFAULT_MAX_CHUNK_SIZE, TimeSeriesPartition


@dataclass
class StoreConfig:
    """Per-dataset store tuning (reference store/IngestionConfig.scala)."""

    max_chunk_size: int = DEFAULT_MAX_CHUNK_SIZE
    max_partitions: int = 1_000_000


class TimeSeriesShard:
    def __init__(self, dataset: str, shard_num: int, config: StoreConfig | None = None):
        self.dataset = dataset
        self.shard_num = shard_num
        self.config = config or StoreConfig()
        self.index = SetBasedPartKeyIndex()
        self.partitions: dict[int, TimeSeriesPartition] = {}
        self._by_partkey: dict[bytes, int] = {}
        self._next_part_id = 0
        self._lock = threading.Lock()
        self.version = 0

    def ingest_series(self, sb: SeriesBatch) -> int:
        """Append one series' samples, creating its partition on first
        sight. Returns the number of rows ingested."""
        with self._lock:
            self.version += 1
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
        pid = self._next_part_id
        self._next_part_id += 1
        self.partitions[pid] = TimeSeriesPartition(
            pid, sb.tags, sb.schema, pk, max_chunk_size=self.config.max_chunk_size,
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
