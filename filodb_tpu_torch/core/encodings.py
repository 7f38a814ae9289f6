"""Chunk codecs (counterpart of ``filodb_tpu/core/encodings.py``; reference
L0 filodb.memory.format): each sealed chunk column encoded whole, in one of
the JAX package's wire formats, byte for byte, so a column store written by
either package is read by the other.

- ``DeltaDelta`` -- int64 as base + slope + zigzag residuals, NibblePack'd;
  an exactly linear run keeps base and slope only (``FMT_CONST_DELTA``).
- ``XorDouble`` -- float64 XOR-ed with the previous value, NibblePack'd;
  integral runs below 2**53 take DeltaDelta instead. NaN payloads
  round-trip bit for bit.
- ``Delta2DHist`` -- ``[T, B]`` cumulative bucket counts (cast to int64):
  delta over time, then over buckets, zigzag + NibblePack.
- ``IntPack`` -- small ints at the narrowest power-of-two bit width.
- ``DictUTF8`` -- a string table and bit-packed codes.

NibblePack runs in one of two tiers, chosen by the caller: ``"library"``
(the default: ``native/codecs.cpp``, built with g++ at first use; a failed
build raises) or ``"python"`` (the group loop below, the same bytes).
``TIER`` is the default tier; ``TIER_CALLS`` counts pack and unpack calls
by the tier that ran them. ``encode_int64_rows``, ``encode_double_rows``
and ``decode_many`` take many equal-length columns at once (a flush
group, a recovery): numpy over the stacked rows and one library call, the
bytes and arrays of the one-column functions.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

FMT_CONST_DELTA = 1  # exactly linear int64 run: base + slope only
FMT_DELTA_DELTA = 2  # int64: base + slope + NibblePack'd zigzag residuals
FMT_XOR_DOUBLE = 3  # float64: XOR with the previous value, NibblePack'd
FMT_RAW_I64 = 4  # incompressible int64
FMT_RAW_F64 = 5  # incompressible float64
FMT_DELTA2D_HIST = 6  # [T, B] int64 histogram: 2D delta, NibblePack'd
FMT_INT_PACK = 7  # small ints bit-packed at a minimal width
FMT_DICT_UTF8 = 8  # dictionary-encoded strings

_HEADER = struct.Struct("<BxHI")  # fmt, pad, reserved, n_elements

TIERS = ("library", "python")
TIER = "library"
TIER_CALLS = {"library": 0, "python": 0}


class CorruptVectorError(ValueError):
    """A damaged payload failed to decode (reference CorruptVectorException,
    ChunkSetInfo.scala:424)."""


def _tier(tier: str | None) -> str:
    tier = TIER if tier is None else tier
    if tier not in TIERS:
        raise ValueError(f"unknown codec tier {tier!r}; one of {TIERS}")
    TIER_CALLS[tier] += 1
    return tier


def _zigzag(v: np.ndarray) -> np.ndarray:
    """Signed int64 -> u64, small magnitudes staying small."""
    v = v.astype(np.int64)
    return ((v << np.int64(1)) ^ (v >> np.int64(63))).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)) ^ -(u & np.uint64(1)).astype(np.int64)


# ---------------------------------------------------------------------------
# NibblePack: groups of 8 u64. [bitmask u8], then when it is not 0
# [header u8: high nibble trailing-zero nibbles, low nibble nnibbles - 1]
# and nnibbles nibbles per nonzero value, low nibble first, byte-padded per
# group.
# ---------------------------------------------------------------------------


def nibble_pack(values: np.ndarray, tier: str | None = None) -> bytes:
    """Pack a u64 array in ``tier`` (``TIER`` when None)."""
    if _tier(tier) == "library":
        from .. import native

        return native.nibble_pack(values)
    return _nibble_pack_py(values)


def _nibble_pack_py(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.uint64)
    out = bytearray()
    for g0 in range(0, len(v), 8):
        grp = v[g0:g0 + 8]
        nz = grp != 0
        bitmask = 0
        for i, x in enumerate(nz):
            if x:
                bitmask |= 1 << i
        out.append(bitmask)
        if bitmask == 0:
            continue
        nzvals = grp[nz]
        tz_bits = lz_bits = 64
        for x in nzvals:
            xi = int(x)
            tz_bits = min(tz_bits, (xi & -xi).bit_length() - 1)
            lz_bits = min(lz_bits, 64 - xi.bit_length())
        tz_nib, lz_nib = tz_bits // 4, lz_bits // 4
        nnib = max(1, 16 - tz_nib - lz_nib)
        out.append(((tz_nib & 0xF) << 4) | (nnib - 1))
        acc = acc_n = 0
        for x in nzvals:
            xi = int(x) >> (tz_nib * 4)
            for k in range(nnib):
                acc |= ((xi >> (4 * k)) & 0xF) << (4 * acc_n)
                acc_n += 1
                if acc_n == 2:
                    out.append(acc)
                    acc = acc_n = 0
        if acc_n:
            out.append(acc)
    return bytes(out)


def nibble_unpack(data: bytes, n: int, tier: str | None = None) -> np.ndarray:
    """Inverse of :func:`nibble_pack`: ``n`` u64 values. A truncated or
    malformed stream raises ``CorruptVectorError`` in both tiers."""
    if _tier(tier) == "library":
        from .. import native

        out = native.nibble_unpack(data, n)
        if out is None:
            raise CorruptVectorError(f"truncated or malformed NibblePack stream ({n} values)")
        return out
    return _nibble_unpack_py(data, n)


def _nibble_unpack_py(data: bytes, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.uint64)
    pos = i = 0
    mv = memoryview(data)
    while i < n:
        glen = min(8, n - i)
        bitmask = mv[pos]
        pos += 1
        if bitmask == 0:
            i += glen
            continue
        hdr = mv[pos]
        pos += 1
        tz_nib, nnib = hdr >> 4, (hdr & 0xF) + 1
        nbytes = (bin(bitmask).count("1") * nnib + 1) // 2
        if pos + nbytes > len(mv):
            raise CorruptVectorError(f"truncated NibblePack stream ({n} values)")
        chunk = int.from_bytes(mv[pos:pos + nbytes], "little")
        pos += nbytes
        vi = 0
        mask_nib = (1 << (4 * nnib)) - 1
        for b in range(glen):
            if bitmask & (1 << b):
                val = (chunk >> (4 * nnib * vi)) & mask_nib
                out[i + b] = np.uint64((val << (4 * tz_nib)) & 0xFFFFFFFFFFFFFFFF)
                vi += 1
        i += glen
    return out


# ---------------------------------------------------------------------------
# Column codecs
# ---------------------------------------------------------------------------


class Encoded(NamedTuple):
    """An encoded chunk column: wire format tag, element count, payload (a
    tuple: a recovery builds hundreds of thousands)."""

    fmt: int
    n: int
    payload: bytes

    def to_bytes(self) -> bytes:
        return _HEADER.pack(self.fmt, 0, self.n) + self.payload

    @staticmethod
    def from_bytes(b) -> "Encoded":
        fmt, _, n = _HEADER.unpack_from(b)
        return Encoded(fmt, n, bytes(b[_HEADER.size:]))

    @property
    def nbytes(self) -> int:
        return _HEADER.size + len(self.payload)


def encode_int64(ts: np.ndarray, tier: str | None = None) -> Encoded:
    """Delta-delta int64 (reference DeltaDeltaVector.scala:28; the constant
    shortcut of :46-60 when the run is exactly linear)."""
    ts = np.ascontiguousarray(ts, dtype=np.int64)
    n = len(ts)
    if n == 0:
        return Encoded(FMT_CONST_DELTA, 0, struct.pack("<qq", 0, 0))
    base = int(ts[0])
    slope = int(round((int(ts[-1]) - base) / (n - 1))) if n > 1 else 0
    resid = ts - (base + slope * np.arange(n, dtype=np.int64))
    if not resid.any():
        return Encoded(FMT_CONST_DELTA, n, struct.pack("<qq", base, slope))
    packed = nibble_pack(_zigzag(resid), tier)
    if len(packed) >= 8 * n:  # incompressible
        return Encoded(FMT_RAW_I64, n, ts.tobytes())
    return Encoded(FMT_DELTA_DELTA, n, struct.pack("<qq", base, slope) + packed)


def encode_double(vals: np.ndarray, tier: str | None = None) -> Encoded:
    """float64: integral runs below 2**53 as delta-delta int64
    (DoubleVector.scala:86-99), else XOR with the previous value and
    NibblePack (NibblePack.scala:73). NaN payloads round-trip bit for bit."""
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    n = len(vals)
    if n and np.isfinite(vals).all():
        with np.errstate(invalid="ignore"):  # past int64: garbage, never equal
            as_int = vals.astype(np.int64)
        if (as_int == vals).all() and np.abs(vals).max() < 2**53:
            enc = encode_int64(as_int, tier)
            if enc.fmt != FMT_RAW_I64:
                return enc
    bits = vals.view(np.uint64)
    xored = np.empty_like(bits)
    if n:
        xored[0] = bits[0]
        xored[1:] = bits[1:] ^ bits[:-1]
    packed = nibble_pack(xored, tier)
    if len(packed) >= 8 * n:
        return Encoded(FMT_RAW_F64, n, vals.tobytes())
    return Encoded(FMT_XOR_DOUBLE, n, packed)


def encode_hist(counts: np.ndarray, tier: str | None = None) -> Encoded:
    """``[T, B]`` cumulative bucket counts (reference HistogramVector 2DDELTA):
    cast to int64, delta along time then along buckets, zigzag, NibblePack."""
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    t, b = counts.shape
    d_time = np.diff(counts, axis=0, prepend=counts[:1] * 0)
    d_time[0] = counts[0]
    d2 = np.diff(d_time, axis=1, prepend=d_time[:, :1] * 0)
    d2[:, 0] = d_time[:, 0]
    packed = nibble_pack(_zigzag(d2.ravel()), tier)
    return Encoded(FMT_DELTA2D_HIST, t * b, struct.pack("<ii", t, b) + packed)


def encode_int_packed(vals: np.ndarray, tier: str | None = None) -> Encoded:
    """Small ints offset by their min and packed at the smallest width of
    1/2/4/8/16/32 bits that fits (reference IntBinaryVector.scala); wider
    runs take delta-delta."""
    v = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(v)
    if n == 0:
        return Encoded(FMT_INT_PACK, 0, struct.pack("<qB", 0, 8))
    base = int(v.min())
    u = (v - base).astype(np.uint64)
    vmax = int(u.max())
    nbits = 64
    for cand in (1, 2, 4, 8, 16, 32, 64):
        if vmax < (1 << cand):
            nbits = cand
            break
    if nbits == 64:
        return encode_int64(vals, tier)
    if nbits >= 8:
        packed = u.astype({8: np.uint8, 16: np.uint16, 32: np.uint32}[nbits]).tobytes()
    else:
        per_byte = 8 // nbits
        pad = (-n) % per_byte
        up = np.concatenate([u, np.zeros(pad, np.uint64)]).astype(np.uint8).reshape(-1, per_byte)
        shifts = (np.arange(per_byte, dtype=np.uint8) * nbits).astype(np.uint8)
        packed = np.bitwise_or.reduce(up << shifts, axis=1).astype(np.uint8).tobytes()
    return Encoded(FMT_INT_PACK, n, struct.pack("<qB", base, nbits) + packed)


def encode_utf8_dict(strings: list, tier: str | None = None) -> Encoded:
    """Dictionary-encoded strings (reference DictUTF8Vector.scala): the
    unique strings NUL-joined, then the bit-packed codes."""
    uniq: dict[str, int] = {}
    codes = np.empty(len(strings), dtype=np.int64)
    for i, s in enumerate(strings):
        codes[i] = uniq.setdefault(s, len(uniq))
    blob = b"\x00".join(s.encode() for s in uniq)
    code_enc = encode_int_packed(codes, tier)
    payload = struct.pack("<II", len(uniq), len(blob)) + blob + code_enc.to_bytes()
    return Encoded(FMT_DICT_UTF8, len(strings), payload)


def decode_utf8_dict(enc: Encoded, tier: str | None = None) -> list:
    n_uniq, blob_len = struct.unpack_from("<II", enc.payload)
    blob = enc.payload[8:8 + blob_len]
    table = [b.decode() for b in blob.split(b"\x00")] if n_uniq else []
    codes = decode(Encoded.from_bytes(enc.payload[8 + blob_len:]), tier)
    return [table[c] for c in codes]


def decode(enc: Encoded, tier: str | None = None) -> np.ndarray:
    """The numpy array of an encoded column. A malformed payload raises
    ``CorruptVectorError``."""
    try:
        return _decode(enc, tier)
    except CorruptVectorError:
        raise
    except (struct.error, IndexError, ValueError, ZeroDivisionError) as e:
        raise CorruptVectorError(f"corrupt vector (fmt={enc.fmt}, n={enc.n}): {e}") from e


def _decode(enc: Encoded, tier: str | None) -> np.ndarray:
    if enc.fmt == FMT_CONST_DELTA:
        base, slope = struct.unpack_from("<qq", enc.payload)
        return base + slope * np.arange(enc.n, dtype=np.int64)
    if enc.fmt == FMT_DELTA_DELTA:
        base, slope = struct.unpack_from("<qq", enc.payload)
        resid = _unzigzag(nibble_unpack(enc.payload[16:], enc.n, tier))
        return base + slope * np.arange(enc.n, dtype=np.int64) + resid
    if enc.fmt == FMT_XOR_DOUBLE:
        bits = np.bitwise_xor.accumulate(nibble_unpack(enc.payload, enc.n, tier))
        return bits.view(np.float64).copy()
    if enc.fmt == FMT_RAW_I64:
        return np.frombuffer(enc.payload, dtype=np.int64, count=enc.n).copy()
    if enc.fmt == FMT_RAW_F64:
        return np.frombuffer(enc.payload, dtype=np.float64, count=enc.n).copy()
    if enc.fmt == FMT_DELTA2D_HIST:
        t, b = struct.unpack_from("<ii", enc.payload)
        d2 = _unzigzag(nibble_unpack(enc.payload[8:], t * b, tier)).reshape(t, b)
        return np.cumsum(np.cumsum(d2, axis=1), axis=0)
    if enc.fmt == FMT_INT_PACK:
        base, nbits = struct.unpack_from("<qB", enc.payload)
        data = enc.payload[9:]
        n = enc.n
        if n == 0:
            return np.empty(0, dtype=np.int64)
        if nbits >= 8:
            dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[nbits]
            u = np.frombuffer(data, dtype=dt, count=n).astype(np.int64)
        else:
            per_byte = 8 // nbits
            raw = np.frombuffer(data, dtype=np.uint8)
            shifts = (np.arange(per_byte, dtype=np.uint8) * nbits).astype(np.uint8)
            mask = np.uint8((1 << nbits) - 1)
            u = ((raw[:, None] >> shifts) & mask).reshape(-1)[:n].astype(np.int64)
        return base + u
    raise ValueError(f"unknown wire format {enc.fmt}")


def encode_int64_rows(a: np.ndarray, tier: str | None = None) -> list[Encoded]:
    """``encode_int64`` of each row of a ``[rows, n]`` int64 array."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    rows, n = a.shape
    out: list = [None] * rows
    lim = 2**52  # below it the slope's float division is Python's, exactly
    fast = (np.abs(a[:, 0]) < lim) & (np.abs(a[:, -1]) < lim) if n else np.zeros(rows, bool)
    if (TIER if tier is None else tier) != "library":
        fast[:] = False
    for r in np.flatnonzero(~fast):
        out[r] = encode_int64(a[r], tier)
    idx = np.flatnonzero(fast)
    if not len(idx):
        return out
    sub = a[idx]
    base = sub[:, 0]
    slope = (np.round((sub[:, -1] - base) / (n - 1)).astype(np.int64) if n > 1
             else np.zeros(len(idx), np.int64))
    resid = sub - (base[:, None] + slope[:, None] * np.arange(n, dtype=np.int64))
    moving = resid.any(axis=1)
    heads = [struct.pack("<qq", b, k) for b, k in zip(base.tolist(), slope.tolist())]
    for j in np.flatnonzero(~moving):
        out[idx[j]] = Encoded(FMT_CONST_DELTA, n, heads[j])
    mv = np.flatnonzero(moving)
    if len(mv):
        packs = nibble_pack_rows(_zigzag(resid[mv]), tier)
        for j, packed in zip(mv.tolist(), packs):
            r = idx[j]
            out[r] = (Encoded(FMT_RAW_I64, n, a[r].tobytes()) if len(packed) >= 8 * n
                      else Encoded(FMT_DELTA_DELTA, n, heads[j] + packed))
    return out


def encode_double_rows(a: np.ndarray, tier: str | None = None) -> list[Encoded]:
    """``encode_double`` of each row of a ``[rows, n]`` float64 array."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    rows, n = a.shape
    if not n or (TIER if tier is None else tier) != "library":
        return [encode_double(r, tier) for r in a]
    out: list = [None] * rows
    with np.errstate(invalid="ignore"):
        as_int = a.astype(np.int64)
    integral = (np.isfinite(a).all(axis=1) & (as_int == a).all(axis=1)
                & (np.abs(a).max(axis=1) < 2**53))
    ii = np.flatnonzero(integral)
    if len(ii):
        for r, enc in zip(ii.tolist(), encode_int64_rows(as_int[ii], tier)):
            if enc.fmt != FMT_RAW_I64:
                out[r] = enc
    xi = np.array([r for r in range(rows) if out[r] is None], dtype=np.int64)
    if len(xi):
        bits = a[xi].view(np.uint64)
        xored = bits.copy()
        xored[:, 1:] ^= bits[:, :-1]
        for r, packed in zip(xi.tolist(), nibble_pack_rows(xored, tier)):
            out[r] = (Encoded(FMT_RAW_F64, n, a[r].tobytes()) if len(packed) >= 8 * n
                      else Encoded(FMT_XOR_DOUBLE, n, packed))
    return out


def nibble_pack_rows(values: np.ndarray, tier: str | None = None) -> list[bytes]:
    """``nibble_pack`` of each row of a ``[rows, n]`` u64 array."""
    if _tier(tier) == "library":
        from .. import native

        return native.nibble_pack_rows(values)
    return [_nibble_pack_py(v) for v in values]


def decode_many(encs: list, tier: str | None = None) -> list[np.ndarray]:
    """``decode`` of each column; the library tier decodes the delta-delta
    and XOR columns of one length together. A malformed payload raises
    ``CorruptVectorError`` as ``decode`` does."""
    out: list = [None] * len(encs)
    groups: dict = {}
    lib = (TIER if tier is None else tier) == "library"
    for i, e in enumerate(encs):
        if lib and e.fmt in (FMT_CONST_DELTA, FMT_DELTA_DELTA, FMT_XOR_DOUBLE) and e.n:
            groups.setdefault((e.fmt, e.n), []).append(i)
        else:
            out[i] = decode(e, tier)
    for (fmt, n), idx in groups.items():
        try:
            rows = _decode_group(fmt, n, [encs[i] for i in idx], tier)
        except (CorruptVectorError, struct.error, IndexError, ValueError):
            rows = [decode(encs[i], tier) for i in idx]  # raises on the bad one
        for i, row in zip(idx, rows):
            out[i] = row
    return out


def _decode_group(fmt: int, n: int, encs: list, tier: str | None) -> list[np.ndarray]:
    steps = np.arange(n, dtype=np.int64)
    if fmt == FMT_XOR_DOUBLE:
        bits = np.bitwise_xor.accumulate(nibble_unpack_rows([e.payload for e in encs], n, tier),
                                         axis=1)
        return [row.copy() for row in bits.view(np.float64)]
    heads = np.frombuffer(b"".join(e.payload[:16] for e in encs), dtype="<i8").reshape(-1, 2)
    if len(heads) != len(encs):
        raise CorruptVectorError("a delta-delta column without its base and slope")
    vals = heads[:, :1] + heads[:, 1:] * steps
    if fmt == FMT_DELTA_DELTA:
        vals += _unzigzag(nibble_unpack_rows([e.payload[16:] for e in encs], n, tier))
    return [row.copy() for row in vals]  # each its own array, as decode gives


def nibble_unpack_rows(streams: list, n: int, tier: str | None = None) -> np.ndarray:
    """``nibble_unpack`` of equal-length streams into a ``[rows, n]`` array."""
    if _tier(tier) == "library":
        from .. import native

        return native.nibble_unpack_rows(streams, n)
    return np.stack([_nibble_unpack_py(b, n) for b in streams])


def decode_double(enc: Encoded, tier: str | None = None) -> np.ndarray:
    """Decode to float64 whatever the integer promotion on the wire."""
    return decode(enc, tier).astype(np.float64, copy=False)
