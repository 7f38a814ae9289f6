"""The host C++ libraries of the port (counterpart of ``filodb_tpu/native``'s
codec and index halves): ``codecs.cpp`` (NibblePack's pack and unpack) and
``index.cpp`` (the part-key index's posting-list core, bound by
``memstore/index_native.py``), each compiled by g++ at first use into
``_build/`` beside the package, named by a hash of its source and flags,
and bound with ctypes.

``build_library`` writes a temporary file and renames it into place, so a
process that loads a library while another builds it reads a whole file
or none. A failed build raises: nothing falls back to a Python tier by
itself (``core/encodings.py`` runs its Python tier only when its caller
asks; the index backend ``"native"`` raises).
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
INDEX_SRC = Path(__file__).resolve().parent / "index.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path(src: Path | None = None, stem: str = "libfilodbcodecs") -> Path:
    """Where the library of ``src`` (default the codecs) and the flags lives."""
    src = SRC if src is None else src
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def build_library(src: Path, stem: str) -> Path:
    """Compile ``src`` into ``_build/<stem>-<hash>.so`` unless that library
    exists; returns its path. Raises ``RuntimeError`` when g++ fails or is
    missing."""
    out = library_path(src, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", tmp],
                                  capture_output=True, text=True, check=False, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: {src.name} cannot be built") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """The codec library, compiled unless it exists."""
    return build_library(SRC, "libfilodbcodecs")


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
