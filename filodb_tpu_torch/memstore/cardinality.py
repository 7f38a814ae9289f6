"""Cardinality tracking (counterpart of ``filodb_tpu/memstore/cardinality.py``;
reference L2 ratelimit/CardinalityTracker.scala:35): a trie over shard-key
prefixes (``_ws_``, ``_ns_``, ``_metric_``) counting the time series each
prefix has seen, which ``TsCardinalitiesExec`` scans.

The port keeps the counts only: its shards evict no series and enforce no
quotas, and nothing persists, so the JAX package's quotas, removals and
JSON snapshot are not copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from ..core.schemas import SHARD_KEY_TAGS


@dataclass
class CardinalityRecord:
    """Counts at one trie node (reference CardinalityRecord)."""

    prefix: tuple[str, ...]
    ts_count: int = 0  # series ever created under the prefix
    active_ts_count: int = 0  # of those, still ingesting
    children: int = 0  # distinct immediate child prefixes


class CardinalityTracker:
    """Trie of shard-key prefixes -> counts."""

    def __init__(self, shard_key_len: int = 3):
        self.shard_key_len = shard_key_len
        self._counts: dict[tuple[str, ...], CardinalityRecord] = {}
        self._child_names: dict[tuple[str, ...], set[str]] = {}

    def _prefixes(self, tags: Mapping[str, str]):
        keys = [tags.get(k, "") for k in SHARD_KEY_TAGS[: self.shard_key_len]]
        for i in range(self.shard_key_len + 1):
            yield tuple(keys[:i])

    def series_created(self, tags: Mapping[str, str]) -> None:
        """Count a new series under every prefix of its shard key (the
        shard calls it where it creates the partition)."""
        prefixes = list(self._prefixes(tags))
        for i, p in enumerate(prefixes):
            rec = self._counts.get(p)
            if rec is None:
                rec = CardinalityRecord(p)
                self._counts[p] = rec
                if i > 0:
                    names = self._child_names.setdefault(prefixes[i - 1], set())
                    if p[-1] not in names:
                        names.add(p[-1])
                        self._counts[prefixes[i - 1]].children += 1
            rec.ts_count += 1
            rec.active_ts_count += 1

    def scan(self, prefix: Sequence[str], depth: int) -> list[CardinalityRecord]:
        """Every record ``depth`` keys deep under ``prefix``, the largest
        first (reference TsCardinalities exec)."""
        prefix = tuple(prefix)
        out = [rec for p, rec in self._counts.items()
               if len(p) == depth and p[: len(prefix)] == prefix]
        out.sort(key=lambda r: -r.ts_count)
        return out

    def record_of(self, prefix: Sequence[str]) -> CardinalityRecord | None:
        return self._counts.get(tuple(prefix))
