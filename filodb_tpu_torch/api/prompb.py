"""A hand-written codec of the Prometheus remote-storage protobuf messages
(``prometheus/prompb``; the JAX package's ``filodb_tpu/api/remote.proto``),
so the port's remote write and read need no protobuf library.

Messages are plain Python objects: a ``WriteRequest`` is a list of
``TimeSeries`` (labels as ``(name, value)`` pairs, samples as ``(value,
timestamp_ms)`` pairs), a ``ReadRequest`` a list of ``Query`` and a
``ReadResponse`` a list of results, each a list of ``TimeSeries``. The
field numbers are prompb's:

    Label        name = 1 (string), value = 2 (string)
    Sample       value = 1 (double), timestamp = 2 (int64)
    TimeSeries   labels = 1, samples = 2 (exemplars 3, histograms 4: skipped)
    WriteRequest timeseries = 1 (metadata 3: skipped)
    LabelMatcher type = 1 (EQ 0, NEQ 1, RE 2, NRE 3), name = 2, value = 3
    Query        start_timestamp_ms = 1, end_timestamp_ms = 2, matchers = 3
    QueryResult  timeseries = 1
    ReadRequest  queries = 1
    ReadResponse results = 1

Decoding skips any field it does not know by its wire type (Prometheus
sends metadata, exemplars, native histograms and read hints in fields
this schema lacks) and rejects a malformed body with ``ValueError``.
Encoding follows proto3: a scalar field at its default (0, "", +0.0) is
left out, so the bytes equal protobuf's own serialization; an int64 is a
varint of its two's complement (10 bytes when negative), a double its
little-endian IEEE 754 bits (NaN and the infinities included).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

VARINT, FIXED64, LEN, FIXED32 = 0, 1, 2, 5

_DOUBLE = struct.Struct("<d")


@dataclass
class TimeSeries:
    labels: list = field(default_factory=list)  # [(name, value)]
    samples: list = field(default_factory=list)  # [(value float, timestamp_ms int)]


@dataclass
class LabelMatcher:
    type: int = 0
    name: str = ""
    value: str = ""


@dataclass
class Query:
    start_timestamp_ms: int = 0
    end_timestamp_ms: int = 0
    matchers: list = field(default_factory=list)  # [LabelMatcher]


# -- wire primitives -----------------------------------------------------------


def _uvarint(data, pos: int) -> tuple[int, int]:
    result = shift = 0
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _int64(u: int) -> int:
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >> 63 else u


def _fields(data):
    """Yield (field number, wire type, value) over one message's bytes: an
    int for VARINT, the raw 8 or 4 bytes for FIXED64 / FIXED32, a
    memoryview for LEN."""
    data = memoryview(data)
    pos, n = 0, len(data)
    while pos < n:
        key, pos = _uvarint(data, pos)
        num, wt = key >> 3, key & 7
        if num == 0:
            raise ValueError("field number 0")
        if wt == VARINT:
            v, pos = _uvarint(data, pos)
        elif wt == FIXED64:
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            v, pos = data[pos:pos + 8], pos + 8
        elif wt == LEN:
            ln, pos = _uvarint(data, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            v, pos = data[pos:pos + ln], pos + ln
        elif wt == FIXED32:
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            v, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield num, wt, v


def _key(num: int, wt: int) -> bytes:
    return _put_uvarint((num << 3) | wt)


def _put_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _put_len(num: int, payload: bytes) -> bytes:
    return _key(num, LEN) + _put_uvarint(len(payload)) + payload


def _put_str(num: int, s: str) -> bytes:
    return _put_len(num, s.encode()) if s else b""


def _put_int64(num: int, v: int) -> bytes:
    return _key(num, VARINT) + _put_uvarint(int(v) & ((1 << 64) - 1)) if v else b""


def _put_double(num: int, v: float) -> bytes:
    raw = _DOUBLE.pack(v)
    return b"" if raw == b"\0" * 8 else _key(num, FIXED64) + raw


def _str(v, wt: int) -> str:
    if wt != LEN:
        raise ValueError("a string field is not length-delimited")
    return bytes(v).decode("utf-8")


# -- messages ------------------------------------------------------------------


def _decode_series(data) -> TimeSeries:
    ts = TimeSeries()
    for num, wt, v in _fields(data):
        if num == 1 and wt == LEN:
            name = value = ""
            for n2, w2, v2 in _fields(v):
                if n2 == 1:
                    name = _str(v2, w2)
                elif n2 == 2:
                    value = _str(v2, w2)
            ts.labels.append((name, value))
        elif num == 2 and wt == LEN:
            val, t = 0.0, 0
            for n2, w2, v2 in _fields(v):
                if n2 == 1 and w2 == FIXED64:
                    val = _DOUBLE.unpack(v2)[0]
                elif n2 == 2 and w2 == VARINT:
                    t = _int64(v2)
            ts.samples.append((val, t))
    return ts


def _encode_series(ts: TimeSeries) -> bytes:
    out = bytearray()
    for name, value in ts.labels:
        out += _put_len(1, _put_str(1, name) + _put_str(2, value))
    for val, t in ts.samples:
        out += _put_len(2, _put_double(1, float(val)) + _put_int64(2, int(t)))
    return bytes(out)


def decode_write_request(data) -> list[TimeSeries]:
    return [_decode_series(v) for num, wt, v in _fields(data) if num == 1 and wt == LEN]


def encode_write_request(series: list[TimeSeries]) -> bytes:
    return b"".join(_put_len(1, _encode_series(ts)) for ts in series)


def _decode_query(data) -> Query:
    q = Query()
    for num, wt, v in _fields(data):
        if num == 1 and wt == VARINT:
            q.start_timestamp_ms = _int64(v)
        elif num == 2 and wt == VARINT:
            q.end_timestamp_ms = _int64(v)
        elif num == 3 and wt == LEN:
            m = LabelMatcher()
            for n2, w2, v2 in _fields(v):
                if n2 == 1 and w2 == VARINT:
                    m.type = _int64(v2)
                elif n2 == 2:
                    m.name = _str(v2, w2)
                elif n2 == 3:
                    m.value = _str(v2, w2)
            q.matchers.append(m)
    return q


def decode_read_request(data) -> list[Query]:
    return [_decode_query(v) for num, wt, v in _fields(data) if num == 1 and wt == LEN]


def encode_read_request(queries: list[Query]) -> bytes:
    out = bytearray()
    for q in queries:
        body = _put_int64(1, q.start_timestamp_ms) + _put_int64(2, q.end_timestamp_ms)
        for m in q.matchers:
            body += _put_len(3, _put_int64(1, m.type) + _put_str(2, m.name)
                             + _put_str(3, m.value))
        out += _put_len(1, body)
    return bytes(out)


def decode_read_response(data) -> list[list[TimeSeries]]:
    results = []
    for num, wt, v in _fields(data):
        if num == 1 and wt == LEN:
            results.append([_decode_series(v2) for n2, w2, v2 in _fields(v)
                            if n2 == 1 and w2 == LEN])
    return results


def encode_read_response(results: list[list[TimeSeries]]) -> bytes:
    return b"".join(
        _put_len(1, b"".join(_put_len(1, _encode_series(ts)) for ts in res))
        for res in results)
