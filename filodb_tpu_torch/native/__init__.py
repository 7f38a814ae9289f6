"""The host codec library of the port (counterpart of ``filodb_tpu/native``'s
codec half): ``codecs.cpp`` (NibblePack's pack and unpack) compiled by g++
at first use into ``_build/`` beside the package, named by a hash of its
source and flags, and bound with ctypes.

The build writes a temporary file and renames it into place, so a process
that loads the library while another builds it reads a whole file or none.
A failed build raises: nothing falls back to the Python tier by itself
(``core/encodings.py`` runs that tier only when its caller asks).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "codecs.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfilodbcodecs-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``codecs.cpp`` unless its library exists; returns its path.
    Raises ``RuntimeError`` when g++ fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                                  capture_output=True, text=True, check=False, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the codec library cannot be built") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            # raw addresses: a typed-pointer cast costs more than the call
            L.fdb_nibble_pack_rows.restype = L.fdb_nibble_unpack_rows.restype = ctypes.c_long
            L.fdb_nibble_pack_rows.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                               ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
            L.fdb_nibble_unpack_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_void_p, ctypes.c_long,
                                                 ctypes.c_void_p, ctypes.c_long]
            _lib = L
    return _lib


def _cap(n: int) -> int:
    """Worst-case stream bytes of n values: two header bytes and 8 x 8
    bytes of nibbles a group."""
    return (n // 8 + 1) * 66


def nibble_pack(values: np.ndarray) -> bytes:
    """NibblePack a u64 array."""
    return nibble_pack_rows(np.asarray(values, dtype=np.uint64)[None])[0]


def nibble_unpack(data: bytes, n: int) -> np.ndarray | None:
    """The ``n`` u64 values of a NibblePack stream, or None when the stream
    is truncated or malformed."""
    try:
        return nibble_unpack_rows([data], n)[0]
    except IndexError:
        return None


def nibble_pack_rows(values: np.ndarray) -> list[bytes]:
    """NibblePack each row of a ``[rows, n]`` u64 array."""
    L = lib()
    v = np.ascontiguousarray(values, dtype=np.uint64)
    rows, n = v.shape
    cap = _cap(n)
    out = np.empty((rows, cap), dtype=np.uint8)
    lens = np.empty(rows, dtype=np.int64)
    if L.fdb_nibble_pack_rows(v.ctypes.data, rows, n, out.ctypes.data, cap, lens.ctypes.data):
        raise RuntimeError(f"fdb_nibble_pack_rows overflowed {cap} bytes a row")
    return [out[r, :k].tobytes() for r, k in enumerate(lens.tolist())]


def nibble_unpack_rows(streams: list, n: int) -> np.ndarray:
    """The ``[rows, n]`` u64 values of equal-length NibblePack streams.
    Raises ``IndexError`` carrying the first bad row's index."""
    L = lib()
    rows = len(streams)
    lens = np.fromiter((len(b) for b in streams), np.int64, rows)
    offs = np.zeros(rows, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    src = np.frombuffer(b"".join(streams), dtype=np.uint8)
    out = np.empty((rows, n), dtype=np.uint64)
    got = L.fdb_nibble_unpack_rows(src.ctypes.data, offs.ctypes.data, lens.ctypes.data, rows,
                                   out.ctypes.data, n)
    if got < 0:
        raise IndexError(-1 - got)
    return out
