"""Part-key index backed by the C++ posting-list core (counterpart of
``filodb_tpu/memstore/index_native.py``; reference analog:
PartKeyTantivyIndex.scala:38 and its Rust tantivy crate), the shard's
``index_backend="native"``.

``NativePartKeyIndex`` is a ``PartKeyIndex`` that also feeds every write
to ``native/index.cpp`` (built by g++ at first use, ``native.build_library``)
and answers there the equality AND with time overlap and the positive
anchored regexes (a literal alternation or a pure prefix as one native
union; a general regex matched over the prefix-narrowed values the core
returns, then one native union). Every other matcher, the label APIs and
introspection go through the inherited bitmap index.

Unlike the JAX package, a library that does not build or load raises: the
backend never turns into the bitmap index by itself. One route does go to
the bitmap path on purpose, with an equal answer: a selector of more than
``MAX_NATIVE_TERMS`` equality matchers, which the core refuses
(``TOO_MANY_TERMS``).
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Iterable, Mapping, Sequence

import numpy as np

from .. import native
from ..core.filters import ColumnFilter
from .index import _LITERAL_ALT, PartKeyIndex, regex_literal_prefix

MAX_NATIVE_TERMS = 64  # index.cpp's fdb_idx_query: lists[64]
TOO_MANY_TERMS = -2  # what fdb_idx_query returns past them

_lock = threading.Lock()
_lib = None


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    c_charpp = ctypes.POINTER(ctypes.c_char_p)
    c_longp = ctypes.POINTER(ctypes.c_long)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    L.fdb_idx_new.restype = ctypes.c_void_p
    L.fdb_idx_free.argtypes = [ctypes.c_void_p]
    L.fdb_idx_add.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        c_charpp, c_longp, c_charpp, c_longp, ctypes.c_int64, ctypes.c_int64,
    ]
    L.fdb_idx_update_end.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64]
    L.fdb_idx_remove.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, c_charpp, c_longp, c_charpp, c_longp,
    ]
    L.fdb_idx_query.restype = ctypes.c_long
    L.fdb_idx_query.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, c_charpp, c_longp, c_charpp, c_longp,
        ctypes.c_int64, ctypes.c_int64, c_i32p, ctypes.c_long,
    ]
    L.fdb_idx_size.restype = ctypes.c_long
    L.fdb_idx_size.argtypes = [ctypes.c_void_p]
    L.fdb_idx_values_prefix.restype = ctypes.c_long
    L.fdb_idx_values_prefix.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long, c_longp,
    ]
    L.fdb_idx_union.restype = ctypes.c_long
    L.fdb_idx_union.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int32, c_charpp, c_longp,
        ctypes.c_int64, ctypes.c_int64, c_i32p, ctypes.c_long,
    ]
    L.fdb_idx_union_prefix.restype = ctypes.c_long
    L.fdb_idx_union_prefix.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int64, ctypes.c_int64, c_i32p, ctypes.c_long,
    ]
    return L


def lib() -> ctypes.CDLL:
    """The index core, built on first use; raises ``RuntimeError`` when g++
    fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(native.build_library(native.INDEX_SRC,
                                                              "libfilodbindex"))))
    return _lib


def _pack_pairs(tags: Mapping[str, str]):
    keys = [k.encode() for k in tags.keys()]
    vals = [v.encode() for v in tags.values()]
    n = len(keys)
    KeyArr = ctypes.c_char_p * n
    LenArr = ctypes.c_long * n
    return (
        n,
        KeyArr(*keys), LenArr(*[len(k) for k in keys]),
        KeyArr(*vals), LenArr(*[len(v) for v in vals]),
    )


class NativePartKeyIndex(PartKeyIndex):
    """PartKeyIndex with the equality and prefix-regex paths in C++. The
    bitmap postings are kept in step for the other matchers and the label
    APIs."""

    def __init__(self):
        super().__init__()
        self._L = lib()
        self._h = self._L.fdb_idx_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._L.fdb_idx_free(h)

    # -- writes kept in both stores ---------------------------------------

    def add_partkey(self, part_id, tags, start_ts, end_ts=2**62):
        super().add_partkey(part_id, tags, start_ts, end_ts)
        n, k, kl, v, vl = _pack_pairs(tags)
        self._L.fdb_idx_add(self._h, part_id, n, k, kl, v, vl, start_ts, min(end_ts, 2**62))

    def update_end_time(self, part_id, end_ts):
        super().update_end_time(part_id, end_ts)
        self._L.fdb_idx_update_end(self._h, part_id, end_ts)

    def remove(self, part_ids: Iterable[int]):
        for pid in list(part_ids):
            tags = self._tags.get(pid)
            if tags is not None:
                n, k, kl, v, vl = _pack_pairs(tags)
                self._L.fdb_idx_remove(self._h, pid, n, k, kl, v, vl)
            super().remove([pid])

    # -- queries ------------------------------------------------------------

    def part_ids_from_filters(self, filters: Sequence[ColumnFilter], start_ts, end_ts,
                              limit=None):
        # equality with "" matches missing tags too (PromQL): bitmap path
        eq = [f for f in filters if f.op == "=" and f.value != ""]
        # positive anchored regexes that cannot match a MISSING tag take the
        # native prefix-range path; everything else the bitmap path
        rex = [
            f for f in filters
            if f.op == "=~" and isinstance(f.value, str) and not f.matches(None)
        ]
        rest = [f for f in filters if not (f.op == "=" and f.value != "") and f not in rex]
        if not eq and not rex:
            return super().part_ids_from_filters(filters, start_ts, end_ts, limit)
        cands = None
        if eq:
            cands = self._query_native(eq, start_ts, end_ts)
        for f in rex:
            ids = self._query_regex_native(f, start_ts, end_ts)
            cands = ids if cands is None else np.intersect1d(
                cands, ids, assume_unique=True
            )
            if not len(cands):
                return np.empty(0, dtype=np.int32)
        if rest:
            keep = [
                p for p in cands.tolist()
                if all(f.matches(self._tags[p].get(f.column)) for f in rest)
            ]
            cands = np.asarray(keep, dtype=np.int32)
        if limit is not None:
            cands = cands[:limit]
        return cands

    def _union(self, key: bytes, values: list[bytes], start_ts, end_ts, out) -> np.ndarray:
        n = len(values)
        got = self._L.fdb_idx_union(
            self._h, key, len(key), n,
            (ctypes.c_char_p * n)(*values),
            (ctypes.c_long * n)(*[len(v) for v in values]),
            start_ts, end_ts, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(out),
        )
        return out[: min(got, len(out))]

    def _query_regex_native(self, f: ColumnFilter, start_ts, end_ts) -> np.ndarray:
        """Range-aware anchored regex: narrow the value dictionary to the
        literal-prefix slice in C++, regex-match only that slice, union the
        postings natively (reference tantivy_utils range-aware regex)."""
        pattern = f.value
        key = f.column.encode()
        out = np.empty(max(len(self._tags), 1), dtype=np.int32)
        if _LITERAL_ALT.match(pattern):
            # a pure literal alternation (a|b|c): one native union, no regex
            return self._union(key, [v.encode() for v in pattern.split("|")], start_ts,
                               end_ts, out)
        prefix, remainder = regex_literal_prefix(pattern)
        if remainder == "":  # a literal: its exact value
            return self._union(key, [prefix.encode()], start_ts, end_ts, out)
        if remainder == ".*":  # a pure prefix: no per-value regex anywhere
            p = prefix.encode()
            got = self._L.fdb_idx_union_prefix(
                self._h, key, len(key), p, len(p), start_ts, end_ts,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(out),
            )
            return out[: min(got, len(out))]
        # a general anchored regex: the prefix-narrowed candidate values,
        # matched here, their postings unioned natively
        rx = re.compile(pattern)
        matched = [v for v in self._values_with_prefix(key, prefix.encode())
                   if rx.fullmatch(v) is not None]
        if not matched:
            return np.empty(0, dtype=np.int32)
        return self._union(key, [v.encode() for v in matched], start_ts, end_ts, out)

    def _values_with_prefix(self, key: bytes, prefix: bytes) -> list[str]:
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            used = ctypes.c_long(0)
            n = self._L.fdb_idx_values_prefix(
                self._h, key, len(key), prefix, len(prefix),
                buf, cap, ctypes.byref(used),
            )
            if used.value <= cap:
                break
            cap = used.value + 16
        out = []
        raw = buf.raw
        off = 0
        for _ in range(n):
            ln = int.from_bytes(raw[off : off + 4], "little")
            out.append(raw[off + 4 : off + 4 + ln].decode())
            off += 4 + ln
        return out

    def _query_native(self, eq_filters, start_ts, end_ts) -> np.ndarray:
        n = len(eq_filters)
        keys = [f.column.encode() for f in eq_filters]
        vals = [f.value.encode() for f in eq_filters]
        KeyArr = ctypes.c_char_p * n
        LenArr = ctypes.c_long * n
        cap = max(len(self._tags), 1)
        out = np.empty(cap, dtype=np.int32)
        got = self._L.fdb_idx_query(
            self._h, n,
            KeyArr(*keys), LenArr(*[len(k) for k in keys]),
            KeyArr(*vals), LenArr(*[len(v) for v in vals]),
            start_ts, end_ts,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if got == TOO_MANY_TERMS:
            # more equality terms than the core takes: the bitmap AND gives
            # the same ids
            return PartKeyIndex.part_ids_from_filters(self, eq_filters, start_ts, end_ts)
        if got < 0:
            raise RuntimeError(f"fdb_idx_query refused {n} equality terms ({got})")
        return np.sort(out[: min(got, cap)])
