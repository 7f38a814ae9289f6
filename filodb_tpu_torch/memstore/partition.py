"""One time series in memory (counterpart of
``filodb_tpu/memstore/partition.py``; reference L2:
memstore/TimeSeriesPartition.scala:64).

A partition appends into a numpy write buffer and seals fixed-max-size
``Chunk``s. Sealed chunks keep their decoded arrays: the JAX package's
default does not encode on seal either, so the codecs stay out of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from ..core.schemas import ColumnType, Schema

DEFAULT_MAX_CHUNK_SIZE = 400  # samples per chunk (reference store config default)


@dataclass
class Chunk:
    """Immutable sealed chunk: one time range of one series, all columns."""

    start_ts: int
    end_ts: int
    n: int
    arrays: dict[str, np.ndarray]

    def column(self, name: str) -> np.ndarray:
        return self.arrays[name]

    @property
    def nbytes_encoded(self) -> int:
        """Bytes of the chunk's encoded form: 0, none is kept."""
        return 0


class TimeSeriesPartition:
    """Write buffer + sealed chunk list for one series. A histogram column
    holds one [B] row of cumulative bucket counts per sample, on the
    partition's ``bucket_les`` bounds."""

    __slots__ = ("part_id", "tags", "schema", "partkey", "chunks", "_buf",
                 "_buf_len", "max_chunk_size", "bucket_les", "_hwm")

    def __init__(self, part_id: int, tags: Mapping[str, str], schema: Schema,
                 partkey: bytes, max_chunk_size: int = DEFAULT_MAX_CHUNK_SIZE,
                 bucket_les: np.ndarray | None = None):
        self.part_id = part_id
        self.tags = dict(tags)
        self.schema = schema
        self.partkey = partkey
        self.chunks: list[Chunk] = []
        self._buf: dict[str, np.ndarray] | None = None
        self._buf_len = 0
        self.max_chunk_size = max_chunk_size
        self.bucket_les = bucket_les
        self._hwm: int = -(2**62)  # newest ingested timestamp

    # -- ingest ------------------------------------------------------------

    def _alloc_buf(self, values: Mapping[str, np.ndarray]) -> None:
        cap = self.max_chunk_size
        buf = {"timestamp": np.empty(cap, dtype=np.int64)}
        for name, arr in values.items():
            buf[name] = np.empty((cap,) + arr.shape[1:], dtype=arr.dtype)
        self._buf = buf
        self._buf_len = 0

    def ingest(self, timestamps: np.ndarray, values: Mapping[str, np.ndarray]) -> int:
        """Append a time-ordered sample run, sealing full chunks as it goes.
        Rows at or before the newest ingested timestamp are dropped, as the
        reference does, so a partition's timestamps are strictly increasing.
        Returns the number of rows ingested."""
        if len(timestamps) == 0:
            return 0
        last = self.latest_ts()
        if timestamps[0] <= last:
            keep = timestamps > last
            if not keep.any():
                return 0
            timestamps = timestamps[keep]
            values = {k: v[keep] for k, v in values.items()}
        n = len(timestamps)
        written = 0
        while written < n:
            if self._buf is None:
                self._alloc_buf(values)
            take = min(self.max_chunk_size - self._buf_len, n - written)
            sl = slice(written, written + take)
            dst = slice(self._buf_len, self._buf_len + take)
            self._buf["timestamp"][dst] = timestamps[sl]
            for k, v in values.items():
                self._buf[k][dst] = v[sl]
            self._buf_len += take
            written += take
            if self._buf_len >= self.max_chunk_size:
                self.switch_buffers()
        self._hwm = max(self._hwm, int(timestamps[-1]))
        return n

    def latest_ts(self) -> int:
        return self._hwm

    def switch_buffers(self) -> Chunk | None:
        """Seal the write buffer into a chunk (reference switchBuffers:232)."""
        if self._buf is None or self._buf_len == 0:
            return None
        n = self._buf_len
        arrays = {k: v[:n].copy() for k, v in self._buf.items()}
        chunk = Chunk(int(arrays["timestamp"][0]), int(arrays["timestamp"][-1]), n, arrays)
        self.chunks.append(chunk)
        self._buf = None
        self._buf_len = 0
        return chunk

    # -- read --------------------------------------------------------------

    def num_samples(self) -> int:
        return sum(c.n for c in self.chunks) + self._buf_len

    def chunks_in_range(self, t0: int, t1: int) -> list[Chunk]:
        return [c for c in self.chunks if c.end_ts >= t0 and c.start_ts <= t1]

    def samples_in_range(self, t0: int, t1: int, col: str) -> tuple[np.ndarray, np.ndarray]:
        """All samples with t0 <= ts <= t1 for one column, including the open
        write buffer. Returns (ts int64, vals); vals is [n, B] for a
        histogram column."""
        ts_parts: list[np.ndarray] = []
        val_parts: list[np.ndarray] = []
        for c in self.chunks:
            if c.end_ts < t0 or c.start_ts > t1:
                continue
            ts = c.column("timestamp")
            lo, hi = np.searchsorted(ts, [t0, t1 + 1])
            if hi > lo:
                ts_parts.append(ts[lo:hi])
                val_parts.append(c.column(col)[lo:hi])
        n, buf = self._buf_len, self._buf
        if buf is not None and n:
            ts = buf["timestamp"][:n]
            lo, hi = np.searchsorted(ts, [t0, t1 + 1])
            if hi > lo:
                ts_parts.append(ts[lo:hi].copy())
                val_parts.append(buf[col][lo:hi].copy())
        if not ts_parts:
            return self._empty(col)
        return np.concatenate(ts_parts), np.concatenate(val_parts)

    def tail_samples(self, t0: int, t1: int, col: str) -> tuple[np.ndarray, np.ndarray]:
        """Lean ``samples_in_range`` for the live-edge append window
        (``staging._append_to_parts`` calls it once per partition per
        extension, so its per-call overhead is the cost at 100k series).
        When every requested sample lies in the open write buffer it
        returns views: no chunk scan, no copies. The views hold until the
        next ingest into this partition; appends land at rows past the
        length read here, so the returned slice itself is never rewritten.
        Falls back to ``samples_in_range`` when a sealed chunk reaches t0."""
        n = self._buf_len
        buf = self._buf
        chunks = self.chunks
        sealed_end = chunks[-1].end_ts if chunks else -(2**62)
        if buf is None or not n or sealed_end >= t0:
            return self.samples_in_range(t0, t1, col)
        ts = buf["timestamp"][:n]
        if ts[-1] < t0 or ts[0] > t1:
            return self._empty(col)
        lo, hi = np.searchsorted(ts, [t0, t1 + 1])
        return ts[lo:hi], buf[col][lo:hi]

    def _empty(self, col: str) -> tuple[np.ndarray, np.ndarray]:
        """No samples: values [0] for a scalar column, [0, B] for a
        histogram column with known bounds."""
        try:
            hist = self.schema.column(col).ctype == ColumnType.HISTOGRAM
        except KeyError:
            hist = False
        if hist and self.bucket_les is not None:
            return np.empty(0, dtype=np.int64), np.empty((0, len(self.bucket_les)))
        return np.empty(0, dtype=np.int64), np.empty(0)
