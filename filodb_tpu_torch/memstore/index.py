"""Part-key index (counterpart of ``SetBasedPartKeyIndex`` in
``filodb_tpu/memstore/index.py``; reference PartKeyLuceneIndex).

Tag postings as Python sets: equality filters read their posting set,
negative and regex filters scan the label's value dictionary. PromQL
semantics: a matcher the empty string satisfies also matches series that
lack the tag.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np

from ..core.filters import ColumnFilter

# a regex that is a plain alternation of literals ("a|b|c")
_LITERAL_ALT = re.compile(r"^[\w-]+(\|[\w-]*)*$")

END_SENTINEL = 2**62  # "still ingesting" (Long.MaxValue analog)


class SetBasedPartKeyIndex:
    def __init__(self):
        self._postings: dict[str, dict[str, set[int]]] = {}
        self._tags: dict[int, Mapping[str, str]] = {}
        self._start: dict[int, int] = {}
        self._end: dict[int, int] = {}
        self._all: set[int] = set()

    def add_partkey(self, part_id: int, tags: Mapping[str, str], start_ts: int,
                    end_ts: int = END_SENTINEL) -> None:
        self._tags[part_id] = tags
        self._start[part_id] = start_ts
        self._end[part_id] = end_ts
        self._all.add(part_id)
        for k, v in tags.items():
            self._postings.setdefault(k, {}).setdefault(v, set()).add(part_id)

    def _ids_for_filter(self, f: ColumnFilter) -> set[int]:
        vals = self._postings.get(f.column, {})
        if f.op == "=":
            out = set(vals.get(f.value, ()))
        elif f.op == "in":
            out = set()
            for v in f.value:
                out |= vals.get(v, set())
        elif f.op == "=~" and isinstance(f.value, str) and _LITERAL_ALT.match(f.value):
            out = set()
            for v in f.value.split("|"):
                out |= vals.get(v, set())
        else:
            # negative / general-regex filters scan the value dictionary
            out = set()
            for v, ids in vals.items():
                if f.matches(v):
                    out |= ids
        if f.matches(None):
            tagged = set()
            for ids in vals.values():
                tagged |= ids
            out |= self._all - tagged
        return out

    def part_ids_from_filters(self, filters: Sequence[ColumnFilter], start_ts: int,
                              end_ts: int, limit: int | None = None) -> np.ndarray:
        ids: set[int] | None = None
        # equality filters first: cheapest and most selective
        for f in sorted(filters, key=lambda f: 0 if f.op in ("=", "in") else 1):
            s = self._ids_for_filter(f)
            ids = s if ids is None else ids & s
            if not ids:
                return np.empty(0, dtype=np.int32)
        if ids is None:
            ids = set(self._all)
        out = sorted(p for p in ids if self._start[p] <= end_ts and self._end[p] >= start_ts)
        if limit is not None:
            out = out[:limit]
        return np.asarray(out, dtype=np.int32)
