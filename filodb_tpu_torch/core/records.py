"""Ingestion records (counterpart of ``filodb_tpu/core/records.py``;
reference L1: binaryrecord2/RecordBuilder.scala).

The unit of ingest is a columnar ``RecordBatch``: numpy arrays per column
plus per-record series tags. A ``SeriesBatch`` is the grouped form (one
series, many time-ordered samples) that ``TimeSeriesShard.ingest_series``
consumes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from .schemas import DatasetOptions, Schema, canonical_partkey, shard_for


@dataclass
class RecordBatch:
    """Columnar batch of ingestion records sharing one schema: ``values``
    maps column name -> [N] array ([N, B] for a histogram column, whose
    bucket bounds are ``bucket_les``), ``tags[i]`` is record i's series
    tags."""

    schema: Schema
    timestamps: np.ndarray
    values: dict[str, np.ndarray]
    tags: Sequence[Mapping[str, str]]
    bucket_les: np.ndarray | None = None  # histogram schemas only

    def __len__(self) -> int:
        return len(self.timestamps)

    def group_by_series(self) -> "list[SeriesBatch]":
        """Group records by partition key, keeping time order within a
        series. Producers repeat one tags object for every sample of a
        series and emit a series' samples contiguously, so grouping walks
        runs of identical objects and memoizes partkeys by object identity.
        A series in one run returns slice views of the batch columns:
        callers must not mutate either side after grouping."""
        groups: dict[bytes, list] = {}
        keys: dict[bytes, Mapping[str, str]] = {}
        memo: dict[int, bytes] = {}
        tags = self.tags
        n = len(tags)
        i = 0
        while i < n:
            t = tags[i]
            j = i + 1
            while j < n and tags[j] is t:
                j += 1
            pk = memo.get(id(t))
            if pk is None:
                pk = canonical_partkey(t)
                memo[id(t)] = pk
            runs = groups.get(pk)
            if runs is None:
                groups[pk] = [(i, j)]
                keys[pk] = t
            else:
                runs.append((i, j))
            i = j
        out = []
        for pk, runs in groups.items():
            if len(runs) == 1:
                ix = slice(*runs[0])
            elif all(hi - lo == 1 for lo, hi in runs):
                ix = np.asarray([lo for lo, _ in runs])
            else:
                ix = np.concatenate([np.arange(lo, hi) for lo, hi in runs])
            out.append(SeriesBatch(
                schema=self.schema, tags=dict(keys[pk]), timestamps=self.timestamps[ix],
                values={k: v[ix] for k, v in self.values.items()},
                bucket_les=self.bucket_les,
            ))
        return out

    def shard_split(self, spread: int, num_shards: int,
                    options: DatasetOptions | None = None) -> dict[int, "RecordBatch"]:
        """Partition the batch by destination shard (the same hashing as
        ``shard_for``), memoized per tags object."""
        options = options or DatasetOptions()
        memo: dict[int, int] = {}

        def shard_memo(t):
            s = memo.get(id(t))
            if s is None:
                s = shard_for(t, spread, num_shards, options)
                memo[id(t)] = s
            return s

        shard_of = np.array([shard_memo(t) for t in self.tags])
        out: dict[int, RecordBatch] = {}
        for s in np.unique(shard_of):
            ix = np.nonzero(shard_of == s)[0]
            out[int(s)] = RecordBatch(
                self.schema, self.timestamps[ix], {k: v[ix] for k, v in self.values.items()},
                [self.tags[i] for i in ix], self.bucket_les,
            )
        return out


@dataclass
class SeriesBatch:
    """Samples for a single series (one partition key), time-ordered."""

    schema: Schema
    tags: Mapping[str, str]
    timestamps: np.ndarray
    values: dict[str, np.ndarray]
    bucket_les: np.ndarray | None = None  # histogram schemas only

    @functools.cached_property
    def partkey(self) -> bytes:
        return canonical_partkey(self.tags)


def gauge_batch(metric: str, samples, schema: Schema | None = None) -> RecordBatch:
    """(tags, ts_ms, value) triples -> a RecordBatch of ``schema`` (default
    gauge), each series' metric defaulting to ``metric``."""
    from .schemas import GAUGE, METRIC_TAG

    schema = schema or GAUGE
    tags_list, ts, vals = [], [], []
    for tags, t, v in samples:
        full = dict(tags)
        full.setdefault(METRIC_TAG, metric)
        tags_list.append(full)
        ts.append(t)
        vals.append(v)
    return RecordBatch(schema, np.asarray(ts, dtype=np.int64),
                       {schema.value_column: np.asarray(vals, dtype=np.float64)}, tags_list)
