"""Part-key tag index (counterpart of ``filodb_tpu/memstore/index.py``;
reference L2: memstore/PartKeyIndex.scala traits, PartKeyLuceneIndex.scala:70
/ PartKeyTantivyIndex.scala:38).

The reference indexes each series' tag map in Lucene or Tantivy and answers
``partIdsFromFilters`` (:655), label names and values, and start/end-time
queries. ``PartKeyIndex`` is the vectorized host index, the shard's
default (``index_backend="python"``):

- every (label, value) owns a posting container (``postings.py``: sorted
  ``int32`` id arrays for sparse values, packed ``uint64`` bitmap words
  once a value covers > 1/32 of the id universe);
- ``part_ids_from_filters`` is AND/OR/ANDNOT over those containers
  (word-wise numpy for dense operands, vectorized bit probes for sparse
  AND dense), never Python set arithmetic, and returns sorted ids;
- the PromQL missing-tag rule (a matcher the EMPTY string satisfies also
  matches series without the tag: ``{k!="v"}``, ``{k=~".*"}``) is one
  bitmap op, ``all &~ tagged[k]``, off the per-label ``tagged`` bitmap
  kept at ingest;
- regex and negative matchers batch over the per-label value dictionary:
  the anchored pattern's literal prefix binary-searches the sorted value
  list down to a candidate slice (the reference tantivy_utils "range-aware
  regex"), the compiled regex runs over the surviving VALUES (never per
  part key), and the matched values' containers OR together; a negative
  matcher finishes with ``tagged &~ positive``;
- start and end times live in flat int64 arrays, so interval overlap and
  ``limit`` are one vectorized mask over the candidate ids;
- repeated selector storms (Grafana variable queries) hit a per-label
  match cache keyed by pattern and invalidated by the label's dictionary
  and postings versions.

The opt-in device tier (``index_device.py``) stages the hottest posting
bitmaps on the card, chosen from the equality traffic ``traffic`` counts,
and resolves an all-equality selector whose matchers are all staged with
one launch of the postings-intersection kernel
(``ops/postings_kernels.py``). The C++ core (``native/index.cpp``) answers
equality ANDs and prefix-narrowed regexes behind the same class
(``index_native.py``, ``index_backend="native"``).

``SetBasedPartKeyIndex`` keeps the original set arithmetic: the
``index_backend="set"`` backend and the oracle of the fuzz tests.
"""

from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict
from typing import Iterable, Mapping, Sequence

import numpy as np

from ..core.filters import ColumnFilter
from . import postings as P

# alternations of pure literals only: '.' and '+' are regex metacharacters
# ('ab+' must regex-match 'abb', never look up the literal value "ab+")
_LITERAL_ALT = re.compile(r"^[\w-]+(\|[\w-]*)*$")

# first regex metacharacter ends the literal prefix (conservative: a
# backslash escape also stops it)
_META = re.compile(r"[.^$*+?()[\]{}|\\]")

END_SENTINEL = 2**62  # "still ingesting" (Long.MaxValue analog)


def regex_literal_prefix(pattern: str) -> tuple[str, str]:
    """Split an anchored regex into (safe literal prefix, remainder) — the
    range-aware regex trick (reference tantivy_utils): ``http_5.*`` scans
    only the ``http_5``-prefixed slice of the value dictionary.

    Safety: every full match MUST start with the returned prefix. A
    quantifier right after the literal run makes its last char optional
    (``ab*`` matches "a"), so it is dropped; an alternation anywhere can
    bypass the prefix entirely (``abc|z``), so the prefix collapses to ""."""
    if "|" in pattern:
        return "", pattern
    m = _META.search(pattern)
    if m is None:
        return pattern, ""
    prefix, remainder = pattern[: m.start()], pattern[m.start():]
    if remainder[:1] in ("*", "?", "{") and prefix:
        prefix = prefix[:-1]
    return prefix, remainder


def filter_op_class(f: ColumnFilter) -> str:
    """Coarse cost class of one matcher: eq | in | prefix | regex | neg
    (the ``filodb_index_lookup_seconds{op_class}`` taxonomy; a multi-filter
    lookup reports its most expensive class)."""
    if f.op == "=":
        return "eq"
    if f.op == "in":
        return "in"
    if f.op == "=~":
        if not isinstance(f.value, str):
            return "regex"
        if _LITERAL_ALT.match(f.value):
            return "in"
        _, rem = regex_literal_prefix(f.value)
        return "prefix" if rem in ("", ".*") else "regex"
    return "neg"


_CLASS_RANK = {"eq": 0, "in": 1, "prefix": 2, "regex": 3, "neg": 4}

# per-filter memos for the two hot per-lookup predicates (ColumnFilter is a
# frozen dataclass, hashable unless an "in" filter carries a list value —
# those fall through to a direct compute)
_OP_CLASS_MEMO: dict = {}
_MISSING_MEMO: dict = {}


def _op_class_cached(f: ColumnFilter) -> str:
    try:
        c = _OP_CLASS_MEMO.get(f)
    except TypeError:
        return filter_op_class(f)
    if c is None:
        c = filter_op_class(f)
        if len(_OP_CLASS_MEMO) > 4096:
            _OP_CLASS_MEMO.clear()
        _OP_CLASS_MEMO[f] = c
    return c


def _matches_missing(f: ColumnFilter) -> bool:
    """Memoized ``f.matches(None)`` — the PromQL missing-tag predicate costs
    a regex engine call per evaluation otherwise."""
    try:
        m = _MISSING_MEMO.get(f)
    except TypeError:
        return f.matches(None)
    if m is None:
        m = f.matches(None)
        if len(_MISSING_MEMO) > 4096:
            _MISSING_MEMO.clear()
        _MISSING_MEMO[f] = m
    return m

# lookup-latency histograms per op class, resolved once (the registry dict
# lookup + lock is measurable at 100k lookups/s)
_LOOKUP_HIST: dict[str, object] = {}


def _observe_lookup(op_class: str, seconds: float) -> None:
    h = _LOOKUP_HIST.get(op_class)
    if h is None:
        from ..metrics import REGISTRY

        h = REGISTRY.micro_histogram(
            "filodb_index_lookup_seconds", op_class=op_class
        )
        _LOOKUP_HIST[op_class] = h
    h.observe(seconds)


class _LabelIndex:
    """Per-label state: value -> container, the label's ``tagged`` bitmap
    (any-value-present), the lazily sorted value dictionary, and two
    monotonic versions — ``dict_version`` bumps when a value appears or
    vanishes (invalidates cached VALUE matches), ``post_version`` bumps on
    every posting change (invalidates cached merged postings and the
    device-staged copies)."""

    __slots__ = ("containers", "tagged", "values_sorted",
                 "dict_version", "post_version")

    def __init__(self, nw: int):
        self.containers: dict[str, P.ValueContainer] = {}
        self.tagged = np.zeros(nw, dtype=np.uint64)
        self.values_sorted: list[str] | None = None
        self.dict_version = 0
        self.post_version = 0

    def sorted_values(self) -> list[str]:
        if self.values_sorted is None:
            self.values_sorted = sorted(self.containers)
        return self.values_sorted


def _prefix_slice(vals: list[str], prefix: str) -> tuple[int, int]:
    """[lo, hi) slice of the sorted value list whose entries start with
    ``prefix`` (binary search; no per-value scan)."""
    import bisect

    if not prefix:
        return 0, len(vals)
    lo = bisect.bisect_left(vals, prefix)
    # smallest string > every prefixed value: bump the last char that can
    # still be bumped (chr 0x10FFFF is the ceiling)
    hi_key = None
    for i in range(len(prefix) - 1, -1, -1):
        c = ord(prefix[i])
        if c < 0x10FFFF:
            hi_key = prefix[:i] + chr(c + 1)
            break
    hi = bisect.bisect_left(vals, hi_key, lo) if hi_key else len(vals)
    return lo, hi


class PartKeyIndex:
    """Inverted bitmap index over one shard's partition keys."""

    REGEX_CACHE_MAX = 256

    def __init__(self):
        self._tags: dict[int, Mapping[str, str]] = {}
        self._labels: dict[str, _LabelIndex] = {}
        self._nbits = 0  # id-universe capacity (multiple of 64)
        self._all = np.zeros(0, dtype=np.uint64)
        self._start = np.zeros(0, dtype=np.int64)
        self._end = np.zeros(0, dtype=np.int64)
        self._lock = threading.RLock()
        # (label, pattern) -> (dict_version, matched values tuple,
        #                      post_version, merged posting view | None)
        self._regex_cache: OrderedDict = OrderedDict()
        # observed equality-selector traffic per (label, value): the device
        # tier's hot-postings chooser input (Storyboard: let the workload
        # pick what gets precomputed/staged). Bounded: coldest half pruned
        # when it overflows.
        self.traffic: dict[tuple[str, str], int] = {}
        self.TRAFFIC_MAX = 4096
        self.device_tier = None  # DevicePostingsTier when opted in
        self.lookups = 0
        # postings_stats amortization: per-label aggregates cached by
        # (dict_version, post_version), whole snapshot TTL'd — the metrics
        # scrape must not hold the index lock for an O(dictionary) walk
        self._label_stats_cache: dict[str, tuple] = {}
        self._stats_snapshot: tuple[float, dict] | None = None

    # -- write -------------------------------------------------------------

    def _grow(self, pid: int) -> None:
        nbits = max(self._nbits * 2, (pid + 64) & ~63, 1024)
        nw = P.nwords(nbits)
        self._all = P.grow_words(self._all, nw)
        ns = np.zeros(nbits, dtype=np.int64)
        ns[: len(self._start)] = self._start
        ne = np.zeros(nbits, dtype=np.int64)
        ne[: len(self._end)] = self._end
        self._start, self._end = ns, ne
        for L in self._labels.values():
            L.tagged = P.grow_words(L.tagged, nw)
        self._nbits = nbits

    def add_partkey(self, part_id: int, tags: Mapping[str, str], start_ts: int,
                    end_ts: int = END_SENTINEL) -> None:
        """reference addPartKey (PartKeyLuceneIndex.scala:505). end defaults
        to 'still ingesting' (Long.MaxValue analog)."""
        if part_id < 0:
            raise ValueError("part ids must be non-negative")
        with self._lock:
            if part_id >= self._nbits:
                self._grow(part_id)
            nw = P.nwords(self._nbits)
            self._tags[part_id] = tags
            self._start[part_id] = start_ts
            self._end[part_id] = min(end_ts, END_SENTINEL)
            P.set_bit(self._all, part_id)
            for k, v in tags.items():
                L = self._labels.get(k)
                if L is None:
                    L = self._labels[k] = _LabelIndex(nw)
                c = L.containers.get(v)
                if c is None:
                    c = L.containers[v] = P.ValueContainer()
                    L.values_sorted = None
                    L.dict_version += 1
                c.add(part_id, self._nbits)
                P.set_bit(L.tagged, part_id)
                L.post_version += 1

    def update_end_time(self, part_id: int, end_ts: int) -> None:
        """reference updatePartKeyWithEndTime:628 (series stopped
        ingesting)."""
        with self._lock:
            if 0 <= part_id < self._nbits:
                self._end[part_id] = min(end_ts, END_SENTINEL)

    def remove(self, part_ids: Iterable[int]) -> None:
        with self._lock:
            by_container: dict[tuple[str, str], list[int]] = {}
            for pid in part_ids:
                pid = int(pid)
                tags = self._tags.pop(pid, None)
                if tags is None:
                    continue
                P.clear_bit(self._all, pid)
                for k, v in tags.items():
                    by_container.setdefault((k, v), []).append(pid)
                    P.clear_bit(self._labels[k].tagged, pid)
            for (k, v), pids in by_container.items():
                L = self._labels[k]
                c = L.containers.get(v)
                if c is None:
                    continue
                c.discard_many(pids, self._nbits)
                L.post_version += 1
                if not len(c):
                    del L.containers[v]
                    L.values_sorted = None
                    L.dict_version += 1

    # -- matcher -> posting view -------------------------------------------

    def _container_view(self, L: _LabelIndex, value: str):
        c = L.containers.get(value)
        return c.view(self._nbits) if c is not None else None

    def _values_posting(self, L: _LabelIndex, values) -> tuple:
        views = []
        for v in values:
            view = self._container_view(L, v)
            if view is not None:
                views.append(view)
        return P.p_or_views(views, P.nwords(self._nbits))

    def _regex_posting(self, L: _LabelIndex, label: str, pattern: str):
        """Dictionary-batched anchored regex -> posting view. One pass over
        the label's sorted value list, prefix-narrowed by binary search;
        matched values' containers OR together. Results cache under
        (label, pattern): matched VALUES survive until the dictionary
        changes, the merged posting until any posting under the label
        changes."""
        key = (label, pattern)
        hit = self._regex_cache.get(key)
        if hit is not None:
            dv, values, pv, merged = hit
            if dv == L.dict_version:
                self._regex_cache.move_to_end(key)
                if pv == L.post_version and merged is not None:
                    return merged
                merged = self._values_posting(L, values)
                self._regex_cache[key] = (dv, values, L.post_version, merged)
                return merged
            del self._regex_cache[key]
        if _LITERAL_ALT.match(pattern):
            values = tuple(v for v in pattern.split("|") if v in L.containers)
        else:
            vals = L.sorted_values()
            prefix, rem = regex_literal_prefix(pattern)
            lo, hi = _prefix_slice(vals, prefix)
            if rem == "":
                values = (prefix,) if prefix in L.containers else ()
            elif rem == ".*":
                values = tuple(vals[lo:hi])
            else:
                rx = re.compile(pattern)
                values = tuple(v for v in vals[lo:hi] if rx.fullmatch(v))
        merged = self._values_posting(L, values)
        self._regex_cache[key] = (L.dict_version, values,
                                  L.post_version, merged)
        while len(self._regex_cache) > self.REGEX_CACHE_MAX:
            self._regex_cache.popitem(last=False)
        return merged

    def _positive_posting(self, f: ColumnFilter, L: _LabelIndex | None):
        """Posting of TAGGED parts whose value satisfies the POSITIVE form
        of the matcher (callers layer the missing-tag rule / negation)."""
        if L is None:
            return P.p_empty()
        if f.op in ("=", "!="):
            view = self._container_view(L, f.value)
            return view if view is not None else P.p_empty()
        if f.op in ("in", "not in"):
            return self._values_posting(L, f.value)
        # "=~" / "!~"
        return self._regex_posting(L, f.column, f.value)

    def _posting_for_filter(self, f: ColumnFilter):
        L = self._labels.get(f.column)
        nw = P.nwords(self._nbits)
        pos = self._positive_posting(f, L)
        if f.op in ("=", "in", "=~"):
            out = pos
        else:
            # negative matcher: tagged &~ positive — ONE dictionary pass +
            # one ANDNOT, never a per-part-key walk
            tagged = ("d", L.tagged) if L is not None else P.p_empty()
            out = P.p_andnot(tagged, pos, nw)
        if _matches_missing(f):
            # PromQL: a matcher satisfied by the EMPTY string also matches
            # series missing the tag entirely ({k!="v"}, {k=~".*"}, {k=""})
            untagged = (P.p_andnot(("d", self._all), ("d", L.tagged), nw)
                        if L is not None else ("d", self._all))
            out = P.p_or_views([out, untagged], nw)
        return out

    # -- query -------------------------------------------------------------

    def part_ids_from_filters(
        self, filters: Sequence[ColumnFilter], start_ts: int, end_ts: int,
        limit: int | None = None,
    ) -> np.ndarray:
        """AND of filters + [start,end] overlap (reference
        partIdsFromFilters), all vectorized over posting views."""
        t0 = time.perf_counter()
        op_class = "eq"
        with self._lock:
            self.lookups += 1
            nw = P.nwords(self._nbits)
            res = None
            if filters:
                classed = [(f, _op_class_cached(f)) for f in filters]
                if len(classed) == 1:
                    op_class = classed[0][1]
                else:
                    op_class = max(
                        (c for _, c in classed), key=_CLASS_RANK.__getitem__
                    )
                    # cheapest, most selective classes first: an empty AND
                    # short-circuits before any regex pass runs
                    classed.sort(key=lambda fc: _CLASS_RANK[fc[1]])
                tier = self.device_tier
                if tier is not None:
                    self._record_traffic(classed)
                    dev = tier.try_intersect(classed)
                    if dev is not None:
                        res = ("d", dev)
                if res is None:
                    for f, _c in classed:
                        p = self._posting_for_filter(f)
                        res = p if res is None else P.p_and(res, p, nw)
                        if P.p_is_empty(res):
                            _observe_lookup(op_class,
                                            time.perf_counter() - t0)
                            return np.empty(0, dtype=np.int32)
            ids = P.p_to_ids(res) if res is not None else P.dense_to_ids(self._all)
            if len(ids) and (start_ts > 0 or end_ts < END_SENTINEL):
                # vectorized [start, end] overlap; skipped for the
                # whole-retention probes metadata endpoints issue
                keep = (self._start[ids] <= end_ts) & (self._end[ids] >= start_ts)
                ids = ids[keep]
            if limit is not None:
                ids = ids[:limit]
            # int32 view at the API edge; boolean indexing above already
            # copied, and sparse pass-throughs are container-owned arrays
            # callers treat as read-only (the original returned fresh
            # arrays, but every consumer only reads/iterates)
            out = np.asarray(ids, dtype=np.int32)
        _observe_lookup(op_class, time.perf_counter() - t0)
        return out

    def _record_traffic(self, classed) -> None:
        tr = self.traffic
        for f, c in classed:
            # {k=""} equality also matches series MISSING the tag (the
            # missing-tag rule below) — a staged posting bitmap alone can't
            # answer it, so it must never become a device-tier candidate
            if c == "eq" and f.value != "":
                key = (f.column, f.value)
                tr[key] = tr.get(key, 0) + 1
        if len(tr) > self.TRAFFIC_MAX:
            keep = sorted(tr.items(), key=lambda kv: -kv[1])[: self.TRAFFIC_MAX // 2]
            self.traffic = dict(keep)

    def label_names(self, filters: Sequence[ColumnFilter], start_ts: int,
                    end_ts: int) -> list[str]:
        """reference labelNamesEfficient:397."""
        with self._lock:
            if not filters:
                return sorted(k for k, L in self._labels.items() if L.containers)
            pids = self.part_ids_from_filters(filters, start_ts, end_ts)
            if not len(pids):
                return []
            nw = P.nwords(self._nbits)
            return sorted(
                k for k, L in self._labels.items()
                if L.containers and bool(
                    P.test_bits(P.grow_words(L.tagged, nw), pids).any()
                )
            )

    def label_values(
        self, filters: Sequence[ColumnFilter], label: str, start_ts: int,
        end_ts: int, limit: int | None = None,
    ) -> list[str]:
        """reference indexValues:445 / labelValuesEfficient."""
        with self._lock:
            if not filters:
                L = self._labels.get(label)
                vals = list(L.sorted_values()) if L is not None else []
            else:
                pids = self.part_ids_from_filters(filters, start_ts, end_ts)
                vset = {self._tags[int(p)].get(label) for p in pids}
                vals = sorted(v for v in vset if v is not None)
            return vals[:limit] if limit else vals

    def partkeys_from_filters(
        self, filters: Sequence[ColumnFilter], start_ts: int, end_ts: int,
        limit: int | None = None,
    ) -> list[Mapping[str, str]]:
        return [self._tags[int(p)]
                for p in self.part_ids_from_filters(filters, start_ts, end_ts, limit)]

    def start_time(self, part_id: int) -> int:
        return int(self._start[part_id])

    def end_time(self, part_id: int) -> int:
        return int(self._end[part_id])

    def tags_of(self, part_id: int) -> Mapping[str, str]:
        return self._tags[part_id]

    def __len__(self) -> int:
        return len(self._tags)

    def cardinality(self, label: str) -> int:
        L = self._labels.get(label)
        return len(L.containers) if L is not None else 0

    def value_counts(self, label: str) -> dict[str, int]:
        """value -> live-series count for one label, O(values) straight off
        the container lengths (no posting walk) — the cardinality report's
        per-label feed (memstore/cardinality.py label_top_values)."""
        with self._lock:
            L = self._labels.get(label)
            if L is None:
                return {}
            return {v: len(c) for v, c in L.containers.items()}

    # -- introspection (metrics + /debug/index) ----------------------------

    def postings_stats(self, max_age_s: float = 5.0) -> dict:
        """Per-label dictionary size + postings footprint, and totals —
        the /debug/index payload and the filodb_index_* gauge feed.

        Amortized two ways so a /metrics scrape never stalls lookups or
        ingest behind an O(dictionary) walk under the index lock: each
        label's aggregate is cached against its (dict_version,
        post_version) pair (quiescent labels — the common case — cost one
        dict probe), and the assembled snapshot is served for
        ``max_age_s`` before any recount happens at all (pass 0 to force
        a fresh walk, e.g. in tests)."""
        snap = self._stats_snapshot
        now = time.monotonic()
        if snap is not None and now - snap[0] < max_age_s:
            out = dict(snap[1])
            out["lookups"] = self.lookups  # always fresh, O(1)
            return out
        with self._lock:
            labels = {}
            total_bytes = total_values = 0
            cache = self._label_stats_cache
            for k, L in self._labels.items():
                ver = (L.dict_version, L.post_version)
                hit = cache.get(k)
                if hit is None or hit[0] != ver:
                    rec = {
                        "values": len(L.containers),
                        # ndarray.nbytes / len() are O(1) per container
                        "postings_bytes": sum(
                            c.nbytes() for c in L.containers.values()
                        ) + L.tagged.nbytes,
                        "dense_containers": sum(
                            1 for c in L.containers.values()
                            if c.words is not None
                        ),
                    }
                    cache[k] = hit = (ver, rec)
                labels[k] = hit[1]
                total_bytes += hit[1]["postings_bytes"]
                total_values += hit[1]["values"]
            for dead in [k for k in cache if k not in self._labels]:
                del cache[dead]
            total_bytes += (self._all.nbytes + self._start.nbytes
                            + self._end.nbytes)
            tier = self.device_tier
            out = {
                "num_part_keys": len(self._tags),
                "capacity_bits": self._nbits,
                "labels": labels,
                "postings_bytes": total_bytes,
                "dictionary_size": total_values,
                "lookups": self.lookups,
                "device": tier.snapshot() if tier is not None else None,
            }
            self._stats_snapshot = (now, out)
            return out


class SetBasedPartKeyIndex:
    """Tag postings as Python sets: equality filters read their posting set,
    negative and regex filters scan the label's value dictionary. ``remove``
    drops a label whose last value vanishes, so ``label_names`` agrees with
    ``PartKeyIndex``."""

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

    def cardinality(self, label: str) -> int:
        return len(self._postings.get(label, {}))

    def value_counts(self, label: str) -> dict[str, int]:
        return {v: len(s) for v, s in self._postings.get(label, {}).items()}
