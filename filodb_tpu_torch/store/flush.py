"""Flush and restart recovery (counterpart of ``filodb_tpu/store/flush.py``;
reference L2/L3: TimeSeriesShard.createFlushTasks:1352 / doFlushSteps:1462 /
writeChunks:1636 / commitCheckpoint:1551; recovery: recoverIndex:774 and
checkpoint replay, doc/ingestion.md:114-133).

A flush, per flush group: seal the write buffers, persist the encoded
chunks and the partkeys, then commit the stream offset's checkpoint.
Recovery reverses it: partitions and index from the partkeys, chunks from
the segments, and the smallest checkpoint to replay the stream from. The
JAX package's downsampler and pre-aggregation hooks are ROADMAP A7; a
server config that asks for them raises.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..core.encodings import decode_many
from ..core.schemas import GAUGE, SCHEMAS
from ..memstore.partition import Chunk, TimeSeriesPartition
from ..memstore.shard import as_column
from .columnstore import ColumnStore, PartkeyMemo, gc_paused


@dataclass
class FlushResult:
    chunks_written: int = 0
    partkeys_written: int = 0
    groups_flushed: int = 0


class FlushCoordinator:
    def __init__(self, memstore, store: ColumnStore):
        self.memstore = memstore
        self.store = store
        # one flush cycle at a time: two concurrent flushes (the maintenance
        # loop and /admin/flush) would both collect the same unflushed
        # chunks before either marks them flushed, and write them twice
        self._lock = threading.RLock()

    def flush_shard(self, dataset: str, shard_num: int, offset: int | None = None) -> FlushResult:
        with self._lock, gc_paused():
            return self._flush_shard(dataset, shard_num, offset)

    def _flush_shard(self, dataset: str, shard_num: int, offset: int | None = None) -> FlushResult:
        shard = self.memstore.shard(dataset, shard_num)
        res = FlushResult()
        offset = offset if offset is not None else shard.ingested_offset
        for group in range(shard.config.groups_per_shard):
            tasks = shard.create_flush_task(group)
            if tasks:
                self.store.write_chunk_sets(
                    dataset, shard_num, group,
                    [(part.tags, part.schema, chunks, part.partkey) for part, chunks in tasks])
                self.store.write_partkeys(
                    dataset, shard_num,
                    [(part.tags, part.earliest_ts(), part.latest_ts()) for part, _ in tasks])
            for part, chunks in tasks:
                part.mark_flushed(chunks[-1].end_ts)
                res.chunks_written += len(chunks)
                res.partkeys_written += 1
                shard.stats.chunks_flushed += len(chunks)
            # the checkpoint commits after the group's chunks and partkeys
            # (reference commitCheckpoint: a replay covers what was lost)
            self.store.write_checkpoint(dataset, shard_num, group, offset)
            res.groups_flushed += 1
        # series that stopped ingesting get a real end time in the index
        shard.update_index_end_times()
        return res

    def flush_all(self, dataset: str) -> FlushResult:
        total = FlushResult()
        with self._lock, gc_paused():
            for s in self.memstore.shard_nums(dataset):
                r = self._flush_shard(dataset, s)
                total.chunks_written += r.chunks_written
                total.partkeys_written += r.partkeys_written
                total.groups_flushed += r.groups_flushed
        return total


def _reconcile_chunks(part: TimeSeriesPartition) -> None:
    """Collapse duplicate or overlapping chunks read from the store: per
    timestamp the sample of the chunk with the later end wins (ties by row
    count), exact duplicates collapse to one; chunks that overlap nothing,
    the normal case, stay as they are. A trimmed chunk keeps decoded arrays
    only and is encoded again at its next flush."""
    chunks = part.chunks
    if len(chunks) < 2 or not any(
            chunks[i].start_ts <= chunks[i - 1].end_ts for i in range(1, len(chunks))):
        return
    claimed: set[int] = set()
    kept = []
    for c in sorted(chunks, key=lambda c: (c.end_ts, c.n), reverse=True):
        ts = np.asarray(c.column("timestamp"))
        mask = np.fromiter((int(t) not in claimed for t in ts), bool, len(ts))
        if mask.all():
            kept.append(c)
        elif mask.any():
            cols = list((c.arrays or c.encoded).keys())
            arrays = {name: np.asarray(c.column(name))[mask] for name in cols}
            tsm = arrays["timestamp"]
            kept.append(Chunk(int(tsm[0]), int(tsm[-1]), int(mask.sum()), arrays))
        claimed.update(int(t) for t in ts)
    part.chunks = sorted(kept, key=lambda c: c.start_ts)


def recover_shard(memstore, store: ColumnStore, dataset: str, shard_num: int) -> int:
    """Rebuild a shard from the column store; returns the smallest
    checkpointed offset to replay the ingestion stream from (-1 if none).

    A partkey's partition is created as a gauge, indexed with its persisted
    start and end times (a resumed ingest makes it live again), and takes
    its schema from its first chunk. As in the JAX package no bucket bounds
    are stored, so a recovered histogram partition has none."""
    with gc_paused():
        return _recover_shard(memstore, store, dataset, shard_num)


def _recover_shard(memstore, store: ColumnStore, dataset: str, shard_num: int) -> int:
    shard = memstore.shard(dataset, shard_num)
    partkey_of = PartkeyMemo()
    for rec in store.read_partkeys(dataset, shard_num):
        tags = rec["tags"]
        pk = partkey_of(tags)
        if pk not in shard._by_partkey:
            shard._create_partition(tags, GAUGE, pk, start_ts=int(rec.get("start", 0)),
                                    end_ts=int(rec.get("end", 2**62)))
    frames = list(store.read_chunks(dataset, shard_num))
    arrays = iter(decode_many([e for _, _, encs in frames for e in encs]))
    for header, schema_name, encs in frames:
        tags = header["tags"]
        pk = partkey_of(tags)
        schema = SCHEMAS[schema_name]
        pid = shard._by_partkey.get(pk)
        if pid is None:
            pid = shard._create_partition(tags, schema, pk, start_ts=int(header["start"]))
        part = shard.partitions[pid]
        part.schema = schema
        encoded = dict(zip(header["cols"], encs))
        decoded = {name: as_column(schema, name, next(arrays)) for name in encoded}
        # persisted in seal order: appended, sorted once below
        part.chunks.append(Chunk(header["start"], header["end"], header["n"], decoded, encoded))
        part.mark_flushed(header["end"])
        shard.evictable.offer(part.part_id)  # recovered chunks are reclaimable
    for part in shard.partitions.values():
        part.chunks.sort(key=lambda c: c.start_ts)
        _reconcile_chunks(part)
    with shard._lock:
        shard._changed_in_place()
    cps = store.read_checkpoints(dataset, shard_num)
    return min(cps.values()) if cps else -1
