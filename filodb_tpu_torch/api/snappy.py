"""Pure-Python snappy block-format codec of the port (a copy of
``filodb_tpu/api/snappy.py``; no python-snappy is needed).

Prometheus remote write/read bodies are snappy block-compressed protobuf.
Decompression implements the full format (literals + copies); compression
emits valid all-literal output (legal snappy — peers decompress it fine;
ratio sacrificed for simplicity).

Format: uvarint uncompressed length, then tagged elements:
  tag & 3 == 0: literal, len = (tag>>2)+1 (60..63 escape to 1-4 length bytes)
  tag & 3 == 1: copy, len = ((tag>>2)&7)+4, offset = (tag>>5)<<8 | next byte
  tag & 3 == 2: copy, len = (tag>>2)+1, offset = next 2 bytes LE
  tag & 3 == 3: copy, len = (tag>>2)+1, offset = next 4 bytes LE
"""

from __future__ import annotations


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


def _write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    if not data:
        return b""
    total, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length < 60:
                length += 1
            else:
                nbytes = length - 59
                length = int.from_bytes(data[pos : pos + nbytes], "little") + 1
                pos += nbytes
            out += data[pos : pos + length]
            pos += length
        else:
            if kind == 1:
                length = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError("bad snappy copy offset")
            start = len(out) - offset
            # copies may overlap forward (run-length style)
            for i in range(length):
                out.append(out[start + i])
    if len(out) != total:
        raise ValueError(f"snappy length mismatch: {len(out)} != {total}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """All-literal snappy encoding (valid, uncompressed-size output)."""
    out = bytearray(_write_uvarint(len(data)))
    pos = 0
    n = len(data)
    while pos < n:
        chunk = min(n - pos, 65536)
        if chunk <= 60:
            out.append((chunk - 1) << 2)
        elif chunk <= 0xFF:
            out.append(60 << 2)
            out += (chunk - 1).to_bytes(1, "little")
        else:
            out.append(61 << 2)
            out += (chunk - 1).to_bytes(2, "little")
        out += data[pos : pos + chunk]
        pos += chunk
    return bytes(out)
