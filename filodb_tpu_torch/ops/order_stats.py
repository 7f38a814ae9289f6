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
- ``segment_topk(grid, members, k, bottom)`` -> ``([J, n] kept values,
  [G, J] thresholds)``: topk/bottomk by (...) (B9 grouped, the JAX
  ``topk_mask`` of each group's rows, as the tree's root and its per-shard
  candidate filter call it): per (group, step) the ``min(k, size)`` best
  members keep their finite values, ranked as ``topk_steps`` ranks, ties
  to the lower series index; the threshold is the ``min(k, size)``-th best
  value (a NaN as -inf for topk, +inf for bottomk).
- ``segment_quantile(grid, members, q)`` -> ``[G, J]``: per (group, step)
  the JAX package's interpolated quantile of the group's non-NaN values
  (``rank = clip(q, 0, 1) * max(count - 1, 0)`` in f32; NaN sorts as +inf;
  NaN where the group has no value). Both versions sort -0 below +0, where
  ``jnp.argsort`` ties them; the answer is the same, since the
  interpolation of two zeros is +0 whatever their signs. ``members``
  (``Members``, from ``segment_members``) lists each group's real series.

On a CUDA tensor each wrapper makes one launch of its kernel in
``csrc/order_stats.cu`` (``filodb_topk_steps``, ``filodb_segment_quantile``,
``filodb_segment_topk``;
the radix select they share is ``csrc/order_select.cuh``) or raises; on a
CPU tensor it runs its plain version (``topk_steps_plain``: a stable sort;
``segment_quantile_plain``: two stable argsorts, as the JAX code sorts).
``order_plan`` lays a launch out from the segment sizes alone: a segment
(a step's column, or a large group at one step) takes a thread block
cluster of up to ``MAX_CLUSTER`` blocks, each staging a slice of its keys
in shared memory (route ``staged``), or reading them from device memory
in every pass where a slice would pass ``MAX_SLICE`` keys (``stream``);
groups of at most ``SMALL_SEGMENT`` members take a thread per (group,
step) in tiles (``thread``, the route of a launch with no large group;
``segment_topk`` a thread per (group, step)). ``segment_topk`` over a
column of at most ``STEP_KEYS`` series (a shard leaf's) at k up to
``STEP_MAX_K`` takes the ``step`` route instead: a block per step stages
the column once and selects every group of it there. Launches of the kernels count in
``LAUNCHES``; ``LAST_PLAN`` is the last launch's ``OrderPlan``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build

SMALL_SEGMENT = 16  # groups of at most this many members: one thread each (the kernel's SMALL)
MAX_CLUSTER = 8  # blocks of a cluster (the portable limit)
SLICE_TARGET = 16_384  # keys per block the plan aims at: longer segments take a cluster
MAX_SLICE = 49_152  # keys a block stages (192 KB of dynamic shared memory; the kernel's)
# threads per block on the staged and thread routes: four staged blocks
# share an SM (their shared memory), and the kernels' 64 registers a thread
# leave room for four blocks of 256 threads (two of 512); the streaming
# route keeps more keys in flight with 1024
THREADS = 256
STREAM_THREADS = 1024
# the thread path: groups a block owns x steps it walks at a time (the
# kernel's TILE_GROUPS, TILE_STEPS)
TILE = (32, 32)
# segment_topk's step route: a block of STEP_THREADS per step selects every
# group from the step's column staged twice in shared memory (column and
# group order), for columns of at most STEP_KEYS series (the kernel's)
STEP_THREADS = 256
STEP_KEYS = 24_576
# the step route's largest k (a lane's sorted list in registers; at k = 32
# the per-group route measured faster on an H100)
STEP_MAX_K = 16

# launches of both kernels since the last reset, and the last launch's
# layout (OrderPlan)
LAUNCHES = 0
LAST_PLAN = None

_lib = None


@dataclass(frozen=True)
class OrderPlan:
    """One launch: the kernel (``topk_steps``, ``segment_quantile`` or
    ``segment_topk``), the route of its large segments (``staged``,
    ``stream``; ``thread`` where there are none; ``step`` for a
    ``segment_topk`` whose column a block stages whole, every group of a
    step in one block), blocks per cluster, threads per block, blocks,
    dynamic shared bytes per block, the keys per block of the largest
    segment (``step``: the column), the thread path's tile (groups a block
    owns, steps it walks at a time), and per step the segments a cluster
    (``step``: a warp or the block) selects and those a thread ranks
    (groups of at most ``SMALL_SEGMENT``)."""

    kernel: str
    route: str
    cluster: int
    threads: int
    blocks: int
    smem_bytes: int
    slice: int
    tile: tuple[int, int]
    block_segments: int
    thread_segments: int


@dataclass(frozen=True)
class Members:
    """The member lists of a grouping: ``perm`` int32 [N] (the real series,
    stably ordered by group), ``starts`` int32 [G+1] (group g's members are
    ``perm[starts[g]:starts[g+1]]``), the groups of more than
    ``SMALL_SEGMENT`` members (``large``) and the rest (``small``), int32,
    and the sizes of the largest small and the largest large group (0
    where there is none)."""

    perm: torch.Tensor
    starts: torch.Tensor
    large: torch.Tensor
    small: torch.Tensor
    small_max: int
    large_max: int

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
                   int(sizes[small].max()) if len(small) else 0,
                   int(sizes[large].max()) if len(large) else 0)


def cluster_for(n: int) -> int:
    """Blocks per cluster for a segment of ``n`` keys: the least power of
    two up to ``MAX_CLUSTER`` whose slices hold at most ``SLICE_TARGET``
    keys each."""
    c = 1
    while c < MAX_CLUSTER and -(-n // c) > SLICE_TARGET:
        c *= 2
    return c


def step_smem_bytes(n: int) -> int:
    """The step route's dynamic shared memory over a column of ``n`` series
    (the kernel's ``step_bytes``): the keys in column order and in group
    order and the kept bitmap, each in whole 16-byte groups."""
    return 4 * (2 * ((n + 3) // 4 * 4) + (-(-n // 32) + 3) // 4 * 4)


def order_plan(kernel: str, segment, J: int, cluster: int | None = None,
               threads: int | None = None, by_step: bool | None = None,
               k: int | None = None) -> OrderPlan:
    """The launch of ``kernel`` over J steps: ``segment`` is the column's
    real series count for ``topk_steps`` and the ``Members`` for
    ``segment_quantile`` and ``segment_topk``. The route, cluster and shared
    bytes follow from the largest segment's size alone; ``segment_topk``
    (at ``k``, default any the step route takes) takes the step route
    wherever a block can stage its column (at most ``STEP_KEYS`` members)
    and ``k`` is at most ``STEP_MAX_K``. ``cluster``, ``threads`` and
    ``by_step`` override the plan's choice (for timing other layouts)."""
    step_k = k is None or int(k) <= STEP_MAX_K
    if kernel == "segment_topk" and (segment.perm.numel() <= STEP_KEYS and step_k
                                     if by_step is None else by_step):
        n = segment.perm.numel()
        if n > STEP_KEYS:
            raise ValueError(f"the step route stages at most {STEP_KEYS} series, not {n}")
        if not step_k:
            raise ValueError(f"the step route takes k up to {STEP_MAX_K}, not {k}")
        threads = threads or STEP_THREADS
        if not 32 <= threads <= STEP_THREADS or threads % 32:
            raise ValueError(f"a step's block takes 32 to {STEP_THREADS} threads, not {threads}")
        return OrderPlan(kernel, "step", 1, threads, J, step_smem_bytes(n), n, TILE,
                         segment.large.numel(), segment.small.numel())
    if kernel == "topk_steps":
        seg, n_large, n_small = int(segment), 1, 0
    elif kernel in ("segment_quantile", "segment_topk"):
        seg, n_large, n_small = segment.large_max, segment.large.numel(), segment.small.numel()
    else:
        raise ValueError(f"unknown order-statistics kernel {kernel!r}")
    c = cluster or (cluster_for(seg) if n_large else 1)
    if not 1 <= c <= MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} blocks, not {c}")
    slice_ = (-(-seg // c) + 3) & ~3 if n_large else 0  # whole 16-byte groups (the kernel's slice_of)
    staged = slice_ <= MAX_SLICE
    route = "thread" if not n_large else "staged" if staged else "stream"
    if threads is None:
        threads = STREAM_THREADS if route == "stream" else THREADS
    # thread-path blocks: TILE[0] groups at every step, or (segment_topk) a
    # thread per (group, step)
    tiles = -(-n_small // TILE[0]) if kernel != "segment_topk" else -(-n_small * J // threads)
    blocks = n_large * J * c + -(-tiles // c) * c
    return OrderPlan(kernel, route, c, threads, blocks, 4 * slice_ if staged else 0, slice_,
                     TILE, n_large, n_small)


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


def segment_topk_plain(grid: torch.Tensor, members: Members, k: int, bottom: bool = False):
    """``segment_topk`` in plain torch: per step one stable sort of the
    members by (group, key descending), series order breaking ties, then
    the first ``min(k, size)`` of each group kept (the JAX ``topk_mask`` of
    each group's rows)."""
    J, n = grid.shape
    G = members.num_groups
    dev = grid.device
    perm = members.perm.long()
    starts = members.starts.long()
    sizes = starts[1:] - starts[:-1]
    gm = torch.repeat_interleave(torch.arange(G, device=dev), sizes)  # [N], ascending
    v = grid[:, perm]  # [J, N]
    x = torch.where(torch.isnan(v), float("-inf"), -v if bottom else v)
    # ascending composite: group, then the better key first (stable: series order)
    worse = (2**31 - 1) - order_keys(x).long()
    order = torch.argsort(gm[None, :] * 2**32 + worse, dim=1, stable=True)
    pos = torch.arange(perm.numel(), device=dev)[None, :] - starts[gm][None, :]  # rank in group
    kr = torch.clamp(sizes, max=int(k))
    kept_sorted = (pos < kr[gm][None, :]).expand(J, -1)
    keep = torch.zeros_like(kept_sorted).scatter_(1, order, kept_sorted)
    vals = torch.where(keep & torch.isfinite(v), v, float("nan"))
    out = torch.full((J, n), float("nan"), dtype=torch.float32, device=dev)
    out[:, perm] = vals
    at = (starts[:-1] + kr - 1).clamp(min=0)  # the kr-th best of each group, sorted
    best = torch.gather(x, 1, order)[:, at]  # [J, G]
    thr = torch.where(kr[None, :] > 0, -best if bottom else best, float("nan"))
    return out, thr.T.contiguous()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' argument types on a built library."""
    fn = lib.filodb_topk_steps
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.filodb_segment_quantile
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.filodb_segment_topk
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
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


def topk_steps(grid: torch.Tensor, k: int, bottom: bool = False, n_real: int | None = None,
               plan: OrderPlan | None = None, lib: ctypes.CDLL | None = None):
    """Per step of the [J, S] grid the ``min(k, S)`` best series: returns
    ([k, J] f32 values, [k, J] int32 series indices) on the grid's
    device. ``n_real`` (default S) says that only the first ``n_real``
    series of each step are real and the rest NaN, as the store mode
    writes padded rows: the kernel reads only those. A CUDA grid makes one
    launch of ``filodb_topk_steps`` as ``plan`` (default ``order_plan``'s)
    lays it out, from ``lib`` (default the built source), and raises if the
    launch fails; a CPU grid runs ``topk_steps_plain``."""
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
    plan = plan or order_plan("topk_steps", n, J)
    lib = lib or _load()
    vals = torch.empty((k, J), dtype=torch.float32, device=grid.device)
    idx = torch.empty((k, J), dtype=torch.int32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = lib.filodb_topk_steps(grid.data_ptr(), S, n, J, k, int(bottom), plan.cluster,
                                    plan.threads, plan.smem_bytes, vals.data_ptr(),
                                    idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_steps kernel launch failed ({plan}): cudaError {err}")
    _count(plan)
    return vals, idx


def segment_quantile(grid: torch.Tensor, members: Members, q: float,
                     plan: OrderPlan | None = None, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """``quantile(q, ...)`` of each group's members at each step of the
    [J, S] grid -> [G, J] f32 on the grid's device. A CUDA grid makes one
    launch of ``filodb_segment_quantile`` as ``plan`` (default
    ``order_plan``'s) lays it out, from ``lib`` (default the built source),
    and raises if the launch fails; a CPU grid runs
    ``segment_quantile_plain``."""
    _check_grid(grid)
    if members.perm.device != grid.device:
        raise ValueError(f"members are on {members.perm.device}, the grid on {grid.device}")
    if grid.device.type == "cpu":
        return segment_quantile_plain(grid, members, q)
    J, S = grid.shape
    plan = plan or order_plan("segment_quantile", members, J)
    lib = lib or _load()
    out = torch.empty((members.num_groups, J), dtype=torch.float32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = lib.filodb_segment_quantile(
            grid.data_ptr(), S, J, members.perm.data_ptr(), members.starts.data_ptr(),
            members.large.data_ptr(), members.large.numel(), members.large_max,
            members.small.data_ptr(), members.small.numel(), members.small_max,
            float(np.float32(q)), plan.cluster, plan.threads, plan.smem_bytes, out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"segment_quantile kernel launch failed ({plan}): cudaError {err}")
    _count(plan)
    return out


def segment_topk(grid: torch.Tensor, members: Members, k: int, bottom: bool = False,
                 plan: OrderPlan | None = None, lib: ctypes.CDLL | None = None):
    """``topk``/``bottomk by (...) (k, ...)`` of the [J, n] step-major grid
    (the series contiguous at each step; a column view of a wider grid
    does), whose n columns are exactly the members: returns ``(out [J, n],
    thr [G, J])`` f32 on the grid's device -- ``out`` each series' value
    where it is among its group's ``min(k, size)`` best at the step (a NaN
    ranking last, as -inf for topk and +inf for bottomk; ties to the lower
    series index; -0 below +0) and finite, else NaN; ``thr`` the
    ``min(k, size)``-th best value of each (group, step), a NaN as the
    fill. A CUDA grid makes one launch of ``filodb_segment_topk`` as
    ``plan`` (default ``order_plan``'s) lays it out, from ``lib`` (default
    the built source), and raises if the launch fails; a CPU grid runs
    ``segment_topk_plain``."""
    if grid.dim() != 2 or grid.dtype != torch.float32 or (grid.shape[1] > 1
                                                            and grid.stride(1) != 1):
        raise ValueError(f"the grid must be a [J, n] float32 tensor with its series "
                         f"contiguous, got {tuple(grid.shape)} {grid.dtype}")
    if int(k) < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    J, n = grid.shape
    if members.perm.numel() != n or members.perm.device != grid.device:
        raise ValueError(f"the members must be the grid's {n} series on {grid.device}")
    if grid.device.type == "cpu":
        return segment_topk_plain(grid, members, k, bottom)
    if grid.device.type != "cuda":
        raise ValueError(f"order statistics run on cuda or cpu tensors, not {grid.device}")
    plan = plan or order_plan("segment_topk", members, J, k=k)
    lib = lib or _load()
    out = torch.empty((J, n), dtype=torch.float32, device=grid.device)
    thr = torch.empty((members.num_groups, J), dtype=torch.float32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = lib.filodb_segment_topk(
            grid.data_ptr(), max(grid.stride(0), n, 1), n, J, members.perm.data_ptr(),
            members.starts.data_ptr(), members.large.data_ptr(), members.large.numel(),
            members.large_max, members.small.data_ptr(), members.small.numel(),
            members.small_max, min(int(k), 2**31 - 1), int(bottom), int(plan.route == "step"),
            plan.cluster, plan.threads, plan.smem_bytes, out.data_ptr(), max(n, 1),
            thr.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_topk kernel launch failed ({plan}): cudaError {err}")
    _count(plan)
    return out, thr
