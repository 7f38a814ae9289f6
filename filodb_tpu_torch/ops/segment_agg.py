"""The segment aggregate of the reference tree's map phase (B3 standalone;
counterpart of ``_segment_aggregate_jit``, ``filodb_tpu/ops/aggregations.py:49``,
as ``_partial_aggregate`` calls it once per component).

``segment_components(values, gids, G, comps)`` reduces an ``[S, J]`` grid
(NaN = absent) by the series' group ids into the ``[G, J]`` components
``comps`` of ``COMPONENTS``: count, sum, sumsq (the f32 sum of ``v * v``),
min, max (-0 below +0) and group (1.0 where a group has a value); every
component is NaN where its group has no value at the step. On a CUDA
tensor it makes one launch of ``filodb_segment_aggregate``
(``csrc/segment_agg.cu``) for all of them, or raises; on a CPU tensor it
runs the plain version, ``aggregations.segment_aggregate`` once per
component.

The kernel reads the grid step-major (a step's series contiguous), the
layout of a tree leaf's grid (the store mode's ``[J_pad, S_pad]`` grid,
whose transpose the leaf holds): such a grid is read in place; any other
(a row-major ``[S, J]`` grid, e.g. the sorted-window rung's or a join's)
is copied to that layout once (``step_major``), counted in
``TRANSPOSES``. Launches count in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .aggregations import segment_aggregate

COMPONENTS = ("count", "sum", "sumsq", "min", "max", "group")
ACCUMULATED = 5  # count .. max keep partials; group reads count
SHARED_BUDGET = 48 * 1024  # the [G, J] partials a block keeps in shared memory at most
THREADS = 256

LAUNCHES = 0
TRANSPOSES = 0

_lib = None


def component_mask(comps) -> int:
    """The kernel's bit mask of ``comps`` (count always set)."""
    mask = 1
    for c in comps:
        if c not in COMPONENTS:
            raise ValueError(f"unknown component {c!r} (known: {COMPONENTS})")
        mask |= 1 << COMPONENTS.index(c)
    return mask


def shared_bytes(num_groups: int, num_steps: int, mask: int) -> int:
    """The shared-memory bytes of a launch's [G, J] partials, 0 where they
    pass ``SHARED_BUDGET`` (the global route)."""
    n_acc = sum((mask >> c) & 1 for c in range(ACCUMULATED))
    need = n_acc * num_groups * num_steps * 4
    return need if need <= SHARED_BUDGET else 0


def step_major(values: torch.Tensor) -> torch.Tensor:
    """``values`` [S, J] as the kernel reads it: a [J, S] tensor whose
    series are contiguous at each step (stride 1), the transposed view
    itself where it is so, else a copy (counted in ``TRANSPOSES``)."""
    global TRANSPOSES
    t = values.T
    if t.stride(1) == 1 or t.shape[1] <= 1:
        return t
    TRANSPOSES += 1
    return t.contiguous()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.filodb_segment_aggregate
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("segment_agg"))))
    return _lib


def segment_components(values: torch.Tensor, gids: torch.Tensor, num_groups: int, comps,
                       lib: ctypes.CDLL | None = None) -> dict:
    """``{component: [G, J] f32}`` of ``values`` [S, J] (f32, NaN = absent)
    by ``gids`` (int [S]; a row outside ``[0, G)`` is skipped) for each of
    ``comps``, on the values' device: one kernel launch on a CUDA tensor
    (from ``lib``, default the built source), the plain version on a CPU
    one."""
    global LAUNCHES
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError(f"values must be a [S, J] float32 tensor, got {tuple(values.shape)} "
                         f"{values.dtype}")
    S, J = values.shape
    if gids.shape != (S,) or gids.device != values.device:
        raise ValueError(f"gids must be [{S}] on {values.device}, got {tuple(gids.shape)} on "
                         f"{gids.device}")
    mask = component_mask(comps)
    if values.device.type == "cpu":
        g = gids.long()
        return {c: segment_aggregate(c, values, g, num_groups) for c in comps}
    if values.device.type != "cuda":
        raise ValueError(f"the segment aggregate runs on cuda or cpu tensors, not {values.device}")
    grid = step_major(values)
    gids32 = gids.to(torch.int32).contiguous()
    planes = [c for i, c in enumerate(COMPONENTS) if (mask >> i) & 1]
    out = torch.empty((len(planes), num_groups, J), dtype=torch.float32, device=values.device)
    smem = shared_bytes(num_groups, J, mask)
    lib = lib or _load()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.filodb_segment_aggregate(grid.data_ptr(), max(grid.stride(0), S), S, J,
                                           gids32.data_ptr(), num_groups, mask, THREADS,
                                           int(smem > 0), smem, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_aggregate kernel launch failed (S={S}, J={J}, "
                           f"G={num_groups}, mask={mask}): cudaError {err}")
    LAUNCHES += 1
    return {c: out[planes.index(c)] for c in comps}
