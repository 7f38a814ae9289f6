"""Part-key index (counterpart of ``SetBasedPartKeyIndex`` in
``filodb_tpu/memstore/index.py``; reference PartKeyLuceneIndex).

Tag postings as Python sets: equality filters read their posting set,
negative and regex filters scan the label's value dictionary. PromQL
semantics: a matcher the empty string satisfies also matches series that
lack the tag. The metadata queries (label names, label values, the label
sets of the matching series) read the same postings. Each part id carries
its start and end time: the end time is the "still ingesting" sentinel
until the flush cycle marks the series ended (``update_end_time``), and
time-filtered lookups prune by both. Retention removes a part id with its
postings (``remove``). The bitmap index of the JAX package, its postings
and its native core are ROADMAP A4b.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping, Sequence

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

    def update_end_time(self, part_id: int, end_ts: int) -> None:
        self._end[part_id] = end_ts

    def remove(self, part_ids: Iterable[int]) -> None:
        """Drop part ids with their postings; a label left with no value
        goes too, so ``label_names`` no longer lists it."""
        for pid in part_ids:
            tags = self._tags.pop(pid, None)
            if tags is None:
                continue
            self._all.discard(pid)
            self._start.pop(pid, None)
            self._end.pop(pid, None)
            for k, v in tags.items():
                s = self._postings.get(k, {}).get(v)
                if s is not None:
                    s.discard(pid)
                    if not s:
                        del self._postings[k][v]
                        if not self._postings[k]:
                            del self._postings[k]

    def start_time(self, part_id: int) -> int:
        return self._start[part_id]

    def end_time(self, part_id: int) -> int:
        return self._end[part_id]

    def tags_of(self, part_id: int) -> Mapping[str, str]:
        return self._tags[part_id]

    def __len__(self) -> int:
        return len(self._all)

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

    def label_names(self, filters: Sequence[ColumnFilter], start_ts: int,
                    end_ts: int) -> list[str]:
        if not filters:
            return sorted(self._postings.keys())
        names: set[str] = set()
        for p in self.part_ids_from_filters(filters, start_ts, end_ts):
            names |= set(self._tags[int(p)].keys())
        return sorted(names)

    def label_values(self, filters: Sequence[ColumnFilter], label: str, start_ts: int,
                     end_ts: int, limit: int | None = None) -> list[str]:
        if not filters:
            vals = sorted(self._postings.get(label, {}).keys())
        else:
            pids = self.part_ids_from_filters(filters, start_ts, end_ts)
            vset = {self._tags[int(p)].get(label) for p in pids}
            vals = sorted(v for v in vset if v is not None)
        return vals[:limit] if limit else vals

    def partkeys_from_filters(self, filters: Sequence[ColumnFilter], start_ts: int,
                              end_ts: int, limit: int | None = None) -> list[Mapping[str, str]]:
        return [self._tags[int(p)]
                for p in self.part_ids_from_filters(filters, start_ts, end_ts, limit)]
