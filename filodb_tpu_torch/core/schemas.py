"""Schemas, datasets and partition-key hashing (counterpart of
``filodb_tpu/core/schemas.py``; reference L1: Schemas.scala, Column.scala,
Dataset.scala:38).

The port keeps the two schemas the main path reads (``gauge`` and
``prom-counter``) and the hashing that routes a series to its shard. The
hashes are byte-identical to the JAX package's, so one series lands on the
same shard in both packages.
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass, field
from typing import Mapping, Sequence

SHARD_KEY_TAGS = ("_ws_", "_ns_", "_metric_")
METRIC_TAG = "_metric_"
PROM_METRIC_TAG = "__name__"


class ColumnType(enum.Enum):
    TIMESTAMP = "ts"
    DOUBLE = "double"
    LONG = "long"
    HISTOGRAM = "hist"
    STRING = "string"


@dataclass(frozen=True)
class Column:
    name: str
    ctype: ColumnType
    # counter semantics: monotonically increasing, resets corrected at query
    is_counter: bool = False
    # delta temporality: values are already per-interval increases
    is_delta: bool = False


@dataclass(frozen=True)
class Schema:
    name: str
    columns: Sequence[Column]
    value_column: str  # the default column queries read

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"schema {self.name} has no column {name}")


def _ts() -> Column:
    return Column("timestamp", ColumnType.TIMESTAMP)


SCHEMAS: dict[str, Schema] = {}


def _register(s: Schema) -> Schema:
    SCHEMAS[s.name] = s
    return s


GAUGE = _register(Schema("gauge", [_ts(), Column("value", ColumnType.DOUBLE)], "value"))
PROM_COUNTER = _register(
    Schema("prom-counter", [_ts(), Column("count", ColumnType.DOUBLE, is_counter=True)], "count")
)


@dataclass(frozen=True)
class DatasetOptions:
    shard_key_columns: Sequence[str] = SHARD_KEY_TAGS
    metric_column: str = METRIC_TAG


@dataclass
class Dataset:
    """dataset = name + allowed schemas + options (reference Dataset.scala:38)."""

    name: str
    schemas: Sequence[Schema] = field(default_factory=lambda: list(SCHEMAS.values()))
    options: DatasetOptions = field(default_factory=DatasetOptions)


# ---------------------------------------------------------------------------
# Partition / shard key hashing
# ---------------------------------------------------------------------------


def canonical_partkey(tags: Mapping[str, str]) -> bytes:
    """Canonical byte form of a series identity: sorted tag pairs, with
    Prometheus ``__name__`` normalized to ``_metric_``."""
    items = []
    for k, v in tags.items():
        if k == PROM_METRIC_TAG:
            k = METRIC_TAG
        items.append((k, v))
    items.sort()
    return "\x00".join(f"{k}\x01{v}" for k, v in items).encode()


def hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def partkey_hash(tags: Mapping[str, str]) -> int:
    return hash64(canonical_partkey(tags))


def shardkey_hash(tags: Mapping[str, str], options: DatasetOptions = DatasetOptions()) -> int:
    """Hash of only the shard-key columns (RecordBuilder.shardKeyHash analog)."""
    norm = {(METRIC_TAG if k == PROM_METRIC_TAG else k): v for k, v in tags.items()}
    parts = "\x00".join(f"{c}\x01{norm.get(c, '')}" for c in options.shard_key_columns)
    return hash64(parts.encode())


def ingestion_shard(shard_key_hash: int, part_key_hash: int, spread: int, num_shards: int) -> int:
    """Shard routing with spread (reference ShardMapper.ingestionShard): the
    shard-key hash picks the 2^spread shard group, the low ``spread`` bits
    of the partition hash pick the shard within it."""
    mask = (1 << spread) - 1
    return (((shard_key_hash & ~mask) | (part_key_hash & mask)) & 0x7FFFFFFF) % num_shards


def shard_for(
    tags: Mapping[str, str], spread: int, num_shards: int,
    options: DatasetOptions = DatasetOptions(),
) -> int:
    return ingestion_shard(shardkey_hash(tags, options), partkey_hash(tags), spread, num_shards)


def shard_group(shard_key_hash: int, spread: int, num_shards: int) -> set[int]:
    """All shards a shard-key hash can route to: the exact image of
    ``ingestion_shard`` over all partition hashes (query-side pruning)."""
    return {
        ingestion_shard(shard_key_hash, low, spread, num_shards)
        for low in range(1 << spread)
    }
