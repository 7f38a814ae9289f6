"""Repair and maintenance jobs over a column store (counterpart of
``filodb_tpu/store/repair.py``; reference spark-jobs repair/ChunkCopier,
PartitionKeysCopier and cardbuster/CardinalityBusterMain): copy chunks and
partkeys between stores, and delete the series that match filters.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

from ..core.filters import ColumnFilter
from ..core.schemas import SCHEMAS, canonical_partkey
from ..memstore.partition import Chunk
from .columnstore import ColumnStore, LocalColumnStore


def copy_chunks(src: ColumnStore, dst: ColumnStore, dataset: str, shard_nums: Sequence[int],
                start_ms: int | None = None, end_ms: int | None = None) -> int:
    """Copy chunk sets, optionally those overlapping [start_ms, end_ms]
    (reference ChunkCopier: cluster migration and repair), re-framed into
    the destination's group 0 in their encoded form. Returns the sets copied."""
    n = 0
    for shard in shard_nums:
        for header, schema_name, encs in src.read_chunks(dataset, shard):
            if start_ms is not None and header["end"] < start_ms:
                continue
            if end_ms is not None and header["start"] > end_ms:
                continue
            schema = SCHEMAS.get(schema_name)
            if schema is None:
                continue
            chunk = Chunk(header["start"], header["end"], header["n"], None,
                          dict(zip(header["cols"], encs)))
            dst.write_chunks(dataset, shard, 0, -1, header["tags"], schema, [chunk])
            n += 1
    return n


def copy_partkeys(src: ColumnStore, dst: ColumnStore, dataset: str,
                  shard_nums: Sequence[int]) -> int:
    """reference PartitionKeysCopier / DSIndexJob."""
    n = 0
    for shard in shard_nums:
        for rec in src.read_partkeys(dataset, shard):
            dst.write_partkey(dataset, shard, rec["tags"], rec["start"], rec["end"])
            n += 1
    return n


def bust_cardinality(store: LocalColumnStore, dataset: str, shard_nums: Sequence[int],
                     filters: Sequence[ColumnFilter]) -> int:
    """Delete the partkeys that match every filter, with their chunks
    (reference CardinalityBusterMain): the shard's partkey journal and
    segments are rewritten without them. Returns the series deleted."""
    deleted = 0
    for shard in shard_nums:
        victims = {canonical_partkey(rec["tags"]) for rec in store.read_partkeys(dataset, shard)
                   if all(f.matches(rec["tags"].get(f.column)) for f in filters)}
        if not victims:
            continue
        deleted += len(victims)
        d = store._shard_dir(dataset, shard)
        keep = [rec for rec in store.read_partkeys(dataset, shard)
                if canonical_partkey(rec["tags"]) not in victims]
        with open(os.path.join(d, "partkeys.jsonl"), "w") as f:
            for rec in keep:
                f.write(json.dumps(rec) + "\n")
        chunks = [(header, schema_name, encs)
                  for header, schema_name, encs in store.read_chunks(dataset, shard)
                  if canonical_partkey(header["tags"]) not in victims]
        for fn in os.listdir(d):
            if fn.startswith("chunks-"):
                os.remove(os.path.join(d, fn))
        for header, schema_name, encs in chunks:
            schema = SCHEMAS.get(schema_name)
            if schema is None:
                continue
            chunk = Chunk(header["start"], header["end"], header["n"], None,
                          dict(zip(header["cols"], encs)))
            store.write_chunks(dataset, shard, 0, -1, header["tags"], schema, [chunk])
    return deleted
