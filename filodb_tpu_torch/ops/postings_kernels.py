"""The postings intersection of the part-key index's device tier (B11;
counterpart of ``filodb_tpu/ops/postings_kernels.py``).

``intersect_words(rows)`` ANDs M packed posting bitmaps of W 64-bit words
each (``memstore/postings.py``'s bit order) into one ``[W]`` result. The
words are held as ``int64`` tensors: the host's ``uint64`` words viewed as
signed (``host_words_to_device``), since torch lacks bitwise ops on
``uint64`` CUDA tensors in several versions; an AND does not care which.
On a CUDA tensor it makes one launch of ``filodb_postings_intersect``
(``csrc/postings.cu``) per ``MAX_ROWS`` rows, or raises; on a CPU tensor it
runs the plain version, ``intersect_words_plain`` (a loop of
``torch.bitwise_and``). Launches count in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import cuda_build

MAX_ROWS = 64  # csrc/postings.cu MAX_ROWS: the bitmaps one launch takes
THREADS = 256

LAUNCHES = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.filodb_postings_intersect.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.filodb_postings_empty.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.filodb_postings_intersect.restype = lib.filodb_postings_empty.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("postings"))))
    return _lib


def host_words_to_device(words: np.ndarray, device) -> torch.Tensor:
    """Host ``uint64`` bitmap words as an ``int64`` tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(device)


def device_words_to_host(words: torch.Tensor) -> np.ndarray:
    """An ``int64`` words tensor back as host ``uint64`` words."""
    return words.cpu().numpy().view(np.uint64)


def _rows(rows) -> list[torch.Tensor]:
    rows = list(rows.unbind(0)) if isinstance(rows, torch.Tensor) else list(rows)
    if not rows:
        raise ValueError("intersect_words needs at least one bitmap")
    W, dev = rows[0].shape, rows[0].device
    for r in rows:
        if r.dim() != 1 or r.shape != W or r.dtype != torch.int64 or r.device != dev:
            raise ValueError(f"every bitmap must be a [{W[0] if len(W) else '?'}] int64 tensor on "
                             f"{dev}, got {tuple(r.shape)} {r.dtype} on {r.device}")
        if r.stride(0) != 1:
            raise ValueError("bitmaps must be contiguous")
    return rows


def intersect_words_plain(rows: Sequence[torch.Tensor] | torch.Tensor) -> torch.Tensor:
    """The AND of the bitmaps, one ``torch.bitwise_and`` a row."""
    rows = _rows(rows)
    out = rows[0].clone()
    for r in rows[1:]:
        torch.bitwise_and(out, r, out=out)
    return out


def intersect_words(rows: Sequence[torch.Tensor] | torch.Tensor,
                    out: torch.Tensor | None = None,
                    lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The ``[W]`` AND of ``rows`` (a sequence of ``[W]`` int64 tensors or an
    ``[M, W]`` one) on their device: on a CUDA tensor one kernel launch (from
    ``lib``, default the built source) per ``MAX_ROWS`` rows into ``out``
    (allocated when None), on a CPU one the plain version."""
    global LAUNCHES
    rows = _rows(rows)
    dev = rows[0].device
    if dev.type == "cpu":
        return intersect_words_plain(rows)
    if dev.type != "cuda":
        raise ValueError(f"the postings intersection runs on cuda or cpu tensors, not {dev}")
    W = rows[0].shape[0]
    if out is None:
        out = torch.empty(W, dtype=torch.int64, device=dev)
    elif out.shape != (W,) or out.dtype != torch.int64 or out.device != dev or (
            W and out.stride(0) != 1):
        raise ValueError(f"out must be a contiguous [{W}] int64 tensor on {dev}")
    lib = lib or _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        todo = rows
        while todo:
            # past MAX_ROWS bitmaps, the next launch ANDs the result so far
            # with the next MAX_ROWS - 1
            take = todo[:MAX_ROWS]
            todo = todo[MAX_ROWS:]
            if todo:
                todo = [out] + todo
            ptrs = (ctypes.c_void_p * len(take))(*[r.data_ptr() for r in take])
            err = lib.filodb_postings_intersect(ptrs, len(take), W, out.data_ptr(), THREADS,
                                                stream)
            if err != 0:
                raise RuntimeError(f"postings_intersect kernel launch failed (M={len(take)}, "
                                   f"W={W}): cudaError {err}")
            LAUNCHES += 1
    return out


def empty_launch(W: int, device) -> None:
    """An empty kernel over the blocks an intersection of ``W`` words
    launches, on ``device``'s current stream: the card's floor for such a
    launch, timed beside it. Not counted anywhere."""
    lib = _load()
    with torch.cuda.device(device):
        err = lib.filodb_postings_empty(int(W), THREADS,
                                        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
