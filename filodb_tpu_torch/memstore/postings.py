"""Posting containers and packed-bitmap math of the part-key index
(counterpart of ``filodb_tpu/memstore/postings.py``; reference analog: the
posting lists inside Lucene / tantivy that back PartKeyLuceneIndex /
PartKeyTantivyIndex).

Each (label, value) pair owns one container holding the part ids carrying
that value:

- **sparse**: a sorted ``int32`` id array (plus an unsorted append buffer
  merged lazily, so ingest is O(1) per id);
- **dense**: packed ``uint64`` words (bit *i* set = part id *i* present),
  promoted to when the sorted array would outweigh the bitmap
  (``4*len > nbits/8``, i.e. the value covers > 1/32 of the id universe).

Query results flow through the same two shapes: a *posting view* is a
``(kind, data)`` pair with kind ``"s"`` (sorted id array) or ``"d"``
(packed words). AND/OR/ANDNOT pick the cheapest combination (sparse AND
dense is a vectorized bit probe, dense AND dense one word-wise ``&`` over
``nbits/64`` words), and nothing turns a dense bitmap into ids unless the
final result is dense. All of it is numpy on host metadata.

Bit order: words are little-endian ``uint64`` viewed as bytes for
pack/unpack, so part id ``i`` lives at word ``i >> 6``, bit ``i & 63``.
The device tier (``index_device.py``) stages these words as they are, 64
bits a word, and ``ops/postings_kernels.intersect_words`` ANDs them.
"""

from __future__ import annotations

import numpy as np

ID_DTYPE = np.int32
EMPTY_IDS = np.empty(0, dtype=ID_DTYPE)
_U64_ONE = np.uint64(1)


def nwords(nbits: int) -> int:
    """Packed words covering an id universe of ``nbits`` ids."""
    return (int(nbits) + 63) >> 6


def grow_words(words: np.ndarray, nw: int) -> np.ndarray:
    if len(words) >= nw:
        return words
    out = np.zeros(nw, dtype=np.uint64)
    out[: len(words)] = words
    return out


def set_bit(words: np.ndarray, pid: int) -> None:
    words[pid >> 6] |= _U64_ONE << np.uint64(pid & 63)


def clear_bit(words: np.ndarray, pid: int) -> None:
    words[pid >> 6] &= ~(_U64_ONE << np.uint64(pid & 63))


def test_bits(words: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Boolean membership of each id in the packed bitmap (vectorized)."""
    if not len(ids):
        return np.zeros(0, dtype=bool)
    idx = np.asarray(ids, dtype=np.int64)
    w = words[idx >> 6]
    return (np.right_shift(w, (idx & 63).astype(np.uint64)) & _U64_ONE) != 0


def ids_to_dense(ids: np.ndarray, nw: int) -> np.ndarray:
    """Sorted-or-not id array -> packed uint64 words of length ``nw``."""
    words = np.zeros(nw, dtype=np.uint64)
    if not len(ids):
        return words
    idx = np.asarray(ids, dtype=np.int64)
    if len(idx) * 16 >= nw * 64:
        # dense enough that one vectorized pack beats scattered or.at
        u8 = np.zeros(nw * 64, dtype=np.uint8)
        u8[idx] = 1
        return np.packbits(u8, bitorder="little").view(np.uint64)
    np.bitwise_or.at(
        words.view(np.uint8), idx >> 3,
        np.left_shift(1, (idx & 7)).astype(np.uint8),
    )
    return words


def dense_to_ids(words: np.ndarray) -> np.ndarray:
    """Packed words -> sorted int64 id array (touches only nonzero words)."""
    nz = np.flatnonzero(words)
    if not len(nz):
        return np.empty(0, dtype=np.int64)
    sub = np.unpackbits(
        np.ascontiguousarray(words[nz]).view(np.uint8), bitorder="little"
    ).reshape(len(nz), 64)
    w, b = np.nonzero(sub)  # row-major -> sorted ids
    return (nz[w] << 6) + b


def popcount(words: np.ndarray) -> int:
    if not len(words):
        return 0
    return int(np.unpackbits(words.view(np.uint8)).sum())


class ValueContainer:
    """Posting container for one (label, value): sparse sorted-array or
    promoted dense bitmap. Adds buffer into ``pending`` (O(1)); reads
    finalize lazily. The owning index serializes mutation vs finalize with
    its lock — the container itself is not thread-safe."""

    __slots__ = ("arr", "words", "count", "pending")

    # promote to dense words when the sorted array would be bigger than the
    # bitmap: 4 bytes/id vs nbits/8 bytes
    PROMOTE_RATIO = 32

    def __init__(self):
        self.arr: np.ndarray | None = EMPTY_IDS  # None once dense
        self.words: np.ndarray | None = None
        self.count = 0  # exact ids held (pending included)
        self.pending: list[int] | None = None

    def __len__(self) -> int:
        return self.count

    def add(self, pid: int, nbits: int = 0) -> None:
        """``nbits`` (the owner's current id-universe capacity) bounds dense
        growth so bitmap width never exceeds — and stays amortized by — the
        universe's own doubling."""
        if self.words is not None:
            w, b = pid >> 6, np.uint64(pid & 63)
            if w >= len(self.words):  # universe grew past this bitmap
                self.words = grow_words(
                    self.words, max(w + 1, nwords(nbits))
                )
            if not (self.words[w] >> b) & _U64_ONE:
                self.words[w] |= _U64_ONE << b
                self.count += 1
            return
        if self.pending is None:
            self.pending = []
        self.pending.append(pid)
        self.count += 1

    def discard_many(self, pids, nbits: int) -> int:
        """Remove the given ids; returns how many were actually present."""
        self.finalize(nbits)
        drop = np.asarray(list(pids), dtype=np.int64)
        if self.words is not None:
            self.words = grow_words(self.words, nwords(nbits))
            present = test_bits(self.words, drop)
            for pid in drop[present]:
                clear_bit(self.words, int(pid))
            self.count -= int(present.sum())
            return int(present.sum())
        keep = np.isin(self.arr, drop, invert=True)
        removed = len(self.arr) - int(keep.sum())
        if removed:
            self.arr = self.arr[keep]
            self.count = len(self.arr)
        return removed

    def finalize(self, nbits: int) -> None:
        """Merge the pending buffer and re-check dense promotion."""
        if self.pending:
            add = np.asarray(self.pending, dtype=ID_DTYPE)
            self.pending = None
            if self.words is not None:  # defensive: adds go direct when dense
                for pid in add:
                    set_bit(self.words, int(pid))
                self.count = popcount(self.words)
            else:
                arr = self.arr
                sorted_add = len(add) == 1 or bool((np.diff(add) > 0).all())
                if sorted_add and (len(arr) == 0 or add[0] > arr[-1]):
                    # ingest fast path: ids arrive in increasing order
                    self.arr = np.concatenate([arr, add]) if len(arr) else add
                else:
                    self.arr = np.union1d(arr, add).astype(ID_DTYPE)
                self.count = len(self.arr)
        if (self.words is None and
                self.count * self.PROMOTE_RATIO > max(nbits, 1)):
            self.words = ids_to_dense(self.arr, nwords(nbits))
            self.arr = None

    def view(self, nbits: int):
        """Current posting view: ('s', sorted ids) or ('d', words)."""
        self.finalize(nbits)
        if self.words is not None:
            return ("d", self.words)
        return ("s", self.arr)

    def nbytes(self) -> int:
        n = 0
        if self.arr is not None:
            n += self.arr.nbytes
        if self.words is not None:
            n += self.words.nbytes
        if self.pending:
            n += 8 * len(self.pending)
        return n


# -- posting-view algebra ---------------------------------------------------


def p_empty():
    return ("s", EMPTY_IDS)


def p_count(p) -> int:
    kind, data = p
    return len(data) if kind == "s" else popcount(data)


def p_is_empty(p) -> bool:
    kind, data = p
    if kind == "s":
        return len(data) == 0
    return not data.any()


def p_and(a, b, nw: int):
    ka, da = a
    kb, db = b
    if ka == "s" and kb == "s":
        return ("s", np.intersect1d(da, db, assume_unique=True))
    if ka == "s":  # sparse ∧ dense: probe bits
        return ("s", da[test_bits(grow_words(db, nw), da)])
    if kb == "s":
        return ("s", db[test_bits(grow_words(da, nw), db)])
    # dense widths may differ (bitmaps grown at different capacities);
    # high words beyond either operand are zero, so align to the widest
    nw = max(nw, len(da), len(db))
    return ("d", grow_words(da, nw) & grow_words(db, nw))


def p_andnot(a, b, nw: int):
    """a \\ b."""
    ka, da = a
    kb, db = b
    if ka == "s":
        if kb == "s":
            return ("s", np.setdiff1d(da, db, assume_unique=True))
        return ("s", da[~test_bits(grow_words(db, nw), da)])
    if kb == "s":
        nw = max(nw, len(da))
        return ("d", grow_words(da, nw) & ~ids_to_dense(db, nw))
    nw = max(nw, len(da), len(db))
    return ("d", grow_words(da, nw) & ~grow_words(db, nw))


def p_or_views(views, nw: int):
    """OR a list of posting views; keeps the result sparse when cheap."""
    if not views:
        return p_empty()
    dense = [d for k, d in views if k == "d"]
    sparse = [d for k, d in views if k == "s" and len(d)]
    if dense:
        nw = max([nw] + [len(d) for d in dense])
        out = np.zeros(nw, dtype=np.uint64)
        for d in dense:
            out[: len(d)] |= d
        if sparse:
            out |= ids_to_dense(np.concatenate(sparse), nw)
        return ("d", out)
    if not sparse:
        return p_empty()
    if len(sparse) == 1:
        return ("s", sparse[0])
    cat = np.concatenate(sparse)
    if len(cat) * 16 >= nw * 64:
        return ("d", ids_to_dense(cat, nw))
    return ("s", np.unique(cat))


def p_to_ids(p) -> np.ndarray:
    """Posting view -> sorted id array (sparse views pass through without a
    copy — callers must not mutate)."""
    kind, data = p
    if kind == "s":
        return data
    return dense_to_ids(data)
