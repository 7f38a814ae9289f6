"""Cardinality tracking (counterpart of ``filodb_tpu/memstore/cardinality.py``;
reference L2 ratelimit/CardinalityTracker.scala:35): a trie over shard-key
prefixes (``_ws_``, ``_ns_``, ``_metric_``) counting the time series each
prefix has seen, which ``TsCardinalitiesExec`` scans, with per-prefix
quotas enforced where a shard creates a partition (``QuotaExceededError``,
raised before anything is counted), the counts of series that stop or are
removed by retention, and a JSON snapshot (the reference's RocksDB store).
``label_top_values`` ranks one label's values by series count off the
part-key index.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Mapping, Sequence

from ..core.schemas import SHARD_KEY_TAGS


class QuotaExceededError(Exception):
    def __init__(self, prefix, quota):
        super().__init__(f"cardinality quota {quota} exceeded at prefix {prefix}")
        self.prefix = prefix
        self.quota = quota


@dataclass
class CardinalityRecord:
    """Counts at one trie node (reference CardinalityRecord)."""

    prefix: tuple[str, ...]
    ts_count: int = 0  # series ever created under the prefix
    active_ts_count: int = 0  # of those, still ingesting
    children: int = 0  # distinct immediate child prefixes


class CardinalityTracker:
    """Trie of shard-key prefixes -> counts and quotas."""

    def __init__(self, shard_key_len: int = 3):
        self.shard_key_len = shard_key_len
        self._counts: dict[tuple[str, ...], CardinalityRecord] = {}
        self._child_names: dict[tuple[str, ...], set[str]] = {}
        self._quotas: dict[tuple[str, ...], int] = {}
        self.default_quota: int | None = None

    def _prefixes(self, tags: Mapping[str, str]):
        keys = [tags.get(k, "") for k in SHARD_KEY_TAGS[: self.shard_key_len]]
        for i in range(self.shard_key_len + 1):
            yield tuple(keys[:i])

    def set_quota(self, prefix: Sequence[str], quota: int) -> None:
        self._quotas[tuple(prefix)] = quota

    def quota_of(self, prefix: tuple[str, ...]) -> int | None:
        return self._quotas.get(prefix, self.default_quota if prefix else None)

    def series_created(self, tags: Mapping[str, str]) -> None:
        """Count a new series under every prefix of its shard key (the
        shard calls it where it creates the partition). Raises
        ``QuotaExceededError``, counting nothing, when a prefix is at its
        quota."""
        prefixes = list(self._prefixes(tags))
        for p in prefixes:
            q = self.quota_of(p)
            rec = self._counts.get(p)
            if q is not None and rec is not None and rec.ts_count >= q:
                raise QuotaExceededError(p, q)
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

    def series_stopped(self, tags: Mapping[str, str]) -> None:
        for p in self._prefixes(tags):
            rec = self._counts.get(p)
            if rec and rec.active_ts_count > 0:
                rec.active_ts_count -= 1

    def series_removed(self, tags: Mapping[str, str]) -> None:
        for p in self._prefixes(tags):
            rec = self._counts.get(p)
            if rec:
                rec.ts_count = max(rec.ts_count - 1, 0)
                rec.active_ts_count = max(rec.active_ts_count - 1, 0)

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

    # -- snapshot (the reference's RocksDB store) --------------------------

    def save(self, path: str) -> None:
        data = {
            "quotas": {"|".join(k): v for k, v in self._quotas.items()},
            "counts": [{"p": list(r.prefix), "t": r.ts_count, "a": r.active_ts_count,
                        "c": r.children} for r in self._counts.values()],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, shard_key_len: int = 3) -> "CardinalityTracker":
        t = cls(shard_key_len)
        if not os.path.exists(path):
            return t
        with open(path) as f:
            data = json.load(f)
        for k, v in data.get("quotas", {}).items():
            t._quotas[tuple(k.split("|")) if k else ()] = v
        for rec in data.get("counts", []):
            p = tuple(rec["p"])
            t._counts[p] = CardinalityRecord(p, rec["t"], rec["a"], rec["c"])
        return t


def label_top_values(index, label: str, k: int = 20) -> list[dict]:
    """Top-K values of one label by live-series count, off the part-key
    index's posting containers (no posting walk): "which value of this
    label is exploding", for the /debug/index?label= drill-down."""
    counts = index.value_counts(label)
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[: int(k)]
    return [{"value": v, "series": n} for v, n in top]
