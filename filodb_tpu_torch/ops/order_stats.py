"""Order statistics across series for the fused epilogues (B9): global
``topk``/``bottomk`` and ``quantile by (...)`` (counterparts of the topk
arm of ``filodb_tpu/ops/aggregations._apply_epilogue`` / ``topk_mask`` and
of ``segment_quantile``).

Both take the step-major ``[J, S_pad]`` per-series grid a rung writes in
its store mode (NaN = absent, padded rows NaN), cut to the query's J real
steps:

- ``topk_steps(grid, k, bottom, n_real)`` -> ``([k, J] values, [k, J]
  int32 series indices)``: per step the k best series, a NaN ranking last
  (as -inf for topk, +inf for bottomk), ties to the lower index, in the
  float's total order (-0 below +0), as ``lax.top_k`` ranks; a winner whose
  value is not finite comes back as NaN. The order inside the k slots is
  free.
- ``segment_quantile(grid, members, q)`` -> ``[G, J]``: per (group, step)
  the JAX package's interpolated quantile of the group's non-NaN values
  (``rank = clip(q, 0, 1) * max(count - 1, 0)`` in f32; NaN sorts as +inf;
  NaN where the group has no value). Both versions sort -0 below +0, where
  ``jnp.argsort`` ties them; the answer is the same, since the
  interpolation of two zeros is +0 whatever their signs. ``members``
  (``Members``, from ``segment_members``) lists each group's real series.

On a CUDA tensor each wrapper makes one launch of its kernel in
``csrc/order_stats.cu`` (``filodb_topk_steps``, ``filodb_segment_quantile``;
the shared radix select is ``csrc/order_select.cuh``) or raises; on a CPU
tensor it runs its plain version (``topk_steps_plain``: a stable sort;
``segment_quantile_plain``: two stable argsorts, as the JAX code sorts).
Launches of both kernels count in ``LAUNCHES``; ``LAST_PLAN`` is the last
launch's ``OrderPlan``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build

SMALL_SEGMENT = 16  # groups of at most this many members: one thread each (the kernel's SMALL)
THREADS = 1024  # threads per block of every launch

# launches of both kernels since the last reset, and the last launch's
# layout (OrderPlan)
LAUNCHES = 0
LAST_PLAN = None

_lib = None


@dataclass(frozen=True)
class OrderPlan:
    """One launch: the kernel (``topk_steps`` or ``segment_quantile``),
    threads per block, blocks, and per step the segments a block selects
    alone and those a thread ranks (groups of at most ``SMALL_SEGMENT``)."""

    kernel: str
    threads: int
    blocks: int
    block_segments: int
    thread_segments: int


@dataclass(frozen=True)
class Members:
    """The member lists of a grouping: ``perm`` int32 [N] (the real series,
    stably ordered by group), ``starts`` int32 [G+1] (group g's members are
    ``perm[starts[g]:starts[g+1]]``), the groups of more than
    ``SMALL_SEGMENT`` members (``large``) and the rest (``small``), int32,
    and the size of the largest small group."""

    perm: torch.Tensor
    starts: torch.Tensor
    large: torch.Tensor
    small: torch.Tensor
    small_max: int

    @property
    def num_groups(self) -> int:
        return self.starts.numel() - 1


def segment_members(gids: torch.Tensor, num_groups: int) -> Members:
    """``Members`` of a grouping from its gids (int [S_padded], padded rows
    in the trash group ``num_groups``), built on the host and placed on
    the gids' device."""
    g = gids.detach().cpu().numpy().astype(np.int64)
    real = np.nonzero((g >= 0) & (g < num_groups))[0]
    perm = real[np.argsort(g[real], kind="stable")]
    sizes = np.bincount(g[real], minlength=num_groups)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    large = np.nonzero(sizes > SMALL_SEGMENT)[0]
    small = np.nonzero(sizes <= SMALL_SEGMENT)[0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(gids.device)

    return Members(put(perm), put(starts), put(large), put(small),
                   int(sizes[small].max()) if len(small) else 0)


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the total order of the f32 ``x``
    (-inf < ... < -0 < +0 < ... < +inf); ``x`` holds no NaN."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def topk_steps_plain(grid: torch.Tensor, k: int, bottom: bool = False):
    """``topk_steps`` in plain torch: per step a stable descending sort of
    the values (negated for bottomk), NaN as -inf, then the first ``k``."""
    x = torch.where(torch.isnan(grid), float("-inf"), -grid if bottom else grid)
    order = torch.argsort(order_keys(x), dim=1, descending=True, stable=True)[:, :k]
    vals = torch.gather(grid, 1, order)
    vals = torch.where(torch.isfinite(vals), vals, float("nan"))
    return vals.T.contiguous(), order.T.to(torch.int32).contiguous()


def segment_quantile_plain(grid: torch.Tensor, members: Members, q: float) -> torch.Tensor:
    """``segment_quantile`` in plain torch, as the JAX code computes it:
    the members' values sorted per step by (group, value) with two stable
    argsorts (NaN as +inf), then the floor and ceil ranks gathered and
    interpolated."""
    J = grid.shape[0]
    G = members.num_groups
    dev = grid.device
    perm = members.perm.long()
    starts = members.starts.long()
    N = perm.numel()
    if N == 0:
        return torch.full((G, J), float("nan"), dtype=torch.float32, device=dev)
    gm = torch.repeat_interleave(torch.arange(G, device=dev), starts[1:] - starts[:-1])  # [N]
    v = grid[:, perm]  # [J, N]
    valid = ~torch.isnan(v)
    count = torch.zeros((G, J), dtype=torch.float32, device=dev).index_add_(
        0, gm, valid.T.to(torch.float32))
    vi = torch.where(valid, v, float("inf"))
    ord1 = torch.argsort(order_keys(vi), dim=1, stable=True)
    ord2 = torch.argsort(gm[ord1], dim=1, stable=True)
    sorted_v = torch.gather(vi, 1, torch.gather(ord1, 1, ord2))
    qt = torch.tensor(q, dtype=torch.float32, device=dev)
    rank = torch.clamp(qt, 0.0, 1.0) * torch.clamp(count - 1.0, min=0.0)  # [G, J]
    lo, hi = torch.floor(rank), torch.ceil(rank)
    unset = torch.isnan(rank)
    base = starts[:-1, None]
    lo_i = (base + torch.where(unset, 0.0, lo).long()).clamp(0, N - 1)
    hi_i = (base + torch.where(unset, 0.0, hi).long()).clamp(0, N - 1)
    v_lo = torch.gather(sorted_v, 1, lo_i.T).T
    v_hi = torch.gather(sorted_v, 1, hi_i.T).T
    out = v_lo + (v_hi - v_lo) * (rank - lo)
    return torch.where(count > 0, out, float("nan"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' argument types on a built library."""
    fn = lib.filodb_topk_steps
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.filodb_segment_quantile
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("order_stats"))))
    return _lib


def _check_grid(grid: torch.Tensor) -> None:
    if grid.dim() != 2 or grid.dtype != torch.float32 or not grid.is_contiguous():
        raise ValueError(f"the grid must be a contiguous [J, S] float32 tensor, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"order statistics run on cuda or cpu tensors, not {grid.device}")


def _count(plan: OrderPlan) -> None:
    global LAUNCHES, LAST_PLAN
    LAUNCHES += 1
    LAST_PLAN = plan


def topk_steps(grid: torch.Tensor, k: int, bottom: bool = False, n_real: int | None = None):
    """Per step of the [J, S] grid the ``min(k, S)`` best series: returns
    ([k, J] f32 values, [k, J] int32 series indices) on the grid's
    device. ``n_real`` (default S) says that only the first ``n_real``
    series of each step are real and the rest NaN, as the store mode
    writes padded rows: the kernel reads only those. A CUDA grid makes one
    launch of ``filodb_topk_steps`` (and raises if the launch fails); a
    CPU grid runs ``topk_steps_plain``."""
    _check_grid(grid)
    if int(k) < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    J, S = grid.shape
    k = min(int(k), S)
    n = S if n_real is None else int(n_real)
    if not 0 <= n <= S:
        raise ValueError(f"n_real must lie in [0, {S}], got {n_real}")
    if grid.device.type == "cpu":
        return topk_steps_plain(grid, k, bottom)
    lib = _load()
    vals = torch.empty((k, J), dtype=torch.float32, device=grid.device)
    idx = torch.empty((k, J), dtype=torch.int32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = lib.filodb_topk_steps(grid.data_ptr(), S, n, J, k, int(bottom), THREADS,
                                    vals.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_steps kernel launch failed: cudaError {err}")
    _count(OrderPlan("topk_steps", THREADS, J, 1, 0))
    return vals, idx


def segment_quantile(grid: torch.Tensor, members: Members, q: float) -> torch.Tensor:
    """``quantile(q, ...)`` of each group's members at each step of the
    [J, S] grid -> [G, J] f32 on the grid's device. A CUDA grid makes one
    launch of ``filodb_segment_quantile`` (and raises if the launch
    fails); a CPU grid runs ``segment_quantile_plain``."""
    _check_grid(grid)
    if members.perm.device != grid.device:
        raise ValueError(f"members are on {members.perm.device}, the grid on {grid.device}")
    if grid.device.type == "cpu":
        return segment_quantile_plain(grid, members, q)
    lib = _load()
    J, S = grid.shape
    G = members.num_groups
    out = torch.empty((G, J), dtype=torch.float32, device=grid.device)
    n_large, n_small = members.large.numel(), members.small.numel()
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = lib.filodb_segment_quantile(
            grid.data_ptr(), S, J, members.perm.data_ptr(), members.starts.data_ptr(),
            members.large.data_ptr(), n_large, members.small.data_ptr(), n_small,
            members.small_max, float(np.float32(q)), THREADS, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_quantile kernel launch failed: cudaError {err}")
    blocks = n_large * J + -(-n_small * J // THREADS)
    _count(OrderPlan("segment_quantile", THREADS, blocks, n_large, n_small))
    return out
