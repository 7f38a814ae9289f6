"""Host side of the fused range kernels' shared machinery
(``csrc/group_acc.cuh``, ``csrc/row_tiles.cuh``): how a launch lays out
its dynamic shared memory, the ``[G+1, J]`` group accumulators it reduces
into, and their finish to ``[G, J]``.

``tile_plan`` decides, from the launch's shapes alone:

- the group-partial variant: ``shared`` (a ``[G, J]`` acc/cnt pair in
  shared memory, flushed once per block) while ``2 * G * J * 4`` bytes fit
  ``PARTIALS_BUDGET``, else ``global`` (global atomics per value, for up to
  one group per series);
- for a kernel that stages rows (the fused window-stats kernel), the rows
  per tile staged in shared memory, double-buffered, within
  ``STAGE_BUDGET``: small tiles leave room for several blocks per SM,
  whose warps hide each other's latency (on an H100 at the main path's
  shape, 2 rows of ts/vals/raw per tile ran 1.5 x faster than 6); rows
  too wide for one row per tile within the 227 KB a block may use are
  read in place from device memory. The regular kernel always reads rows
  in place (``n_arrays`` 0), ``MAX_TILE_ROWS`` rows per tile.

The plan's ``n_arrays`` goes to the kernel's C entry, which lays out its
staging buffers by it: the host's size and the kernel's layout come from
one number.

The store mode (``ACC_STORE``, the fused epilogues topk/bottomk/quantile)
writes every ``(row, step)`` value once to a step-major ``[J_pad, S_pad]``
grid instead (``series_buffer``; its plain counterpart ``series_grid``;
every rung's wrapper runs through ``run_series``): a plan with ``store``
set reserves no partials.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .kernels import pad_steps

ACC_CODES = {"sum": 0, "count": 0, "avg": 0, "min": 1, "max": 2}
# the store mode (csrc/group_acc.cuh ACC_STORE): each (row, step) value,
# NaN included, to the [J_pad, S_pad] grid, trash rows as NaN; the
# wrappers' launches take STORE in place of an op
ACC_STORE = 3
STORE = "store"


def acc_code(op: str) -> int:
    """The kernels' accumulator code of an op, or of ``STORE``."""
    return ACC_STORE if op == STORE else ACC_CODES[op]

STAGE_BUDGET = 40 * 1024  # both tile buffers, aiming at 4-5 blocks per SM
PARTIALS_BUDGET = 56 * 1024  # shared [G, J] acc/cnt partials at most
BLOCK_SMEM = 227 * 1024  # the most dynamic shared memory a block may use
MAX_TILE_ROWS = 8
MAX_LANES = 64  # lanes one lane-mode launch takes (csrc/group_acc.cuh lanes::MAX_LANES)


@dataclass(frozen=True)
class TilePlan:
    """One launch's layout: ``rows`` per tile, ``n_arrays`` arrays staged
    per row in shared memory (0: rows read in place), group partials in
    shared memory or not (none in the store mode, ``store``), and the
    dynamic shared memory that takes."""

    rows: int
    n_arrays: int
    shared: bool
    smem_bytes: int
    store: bool = False

    @property
    def staged(self) -> bool:
        return self.n_arrays > 0

    @property
    def partials(self) -> str:
        return "store" if self.store else ("shared" if self.shared else "global")


def layout(num_groups: int, num_steps: int, row_words: int, n_arrays: int,
           rows: int, store: bool = False, lanes: int = 1) -> TilePlan:
    """The plan of ``rows`` rows per tile, each staging ``n_arrays`` arrays
    of ``row_words`` words in both buffers (``n_arrays`` 0: read in
    place), with the group partials' variant chosen from the shape (none
    in the store mode): a lane-mode launch keeps ``lanes`` pairs of
    partials, one for each lane of a window."""
    part = 0 if store else 2 * lanes * num_groups * num_steps * 4
    shared = not store and part <= PARTIALS_BUDGET
    part = -(-part // 16) * 16 if shared else 0
    return TilePlan(rows, n_arrays, shared, part + rows * 2 * row_words * 4 * n_arrays, store)


@functools.lru_cache(maxsize=256)
def tile_plan(num_groups: int, num_steps: int, row_words: int, n_arrays: int,
              store: bool = False, lanes: int = 1) -> TilePlan:
    """The layout of a launch over ``num_steps`` steps into ``num_groups``
    groups (or, with ``store``, to the per-series grid) that stages
    ``n_arrays`` arrays of ``row_words`` words per row (0 arrays: a kernel
    that reads rows in place); a lane-mode launch counts the most
    ``lanes`` any one window serves."""
    row_bytes = 2 * row_words * 4 * n_arrays  # both buffers
    in_place = layout(num_groups, num_steps, row_words, 0, MAX_TILE_ROWS, store, lanes)
    if not row_bytes or in_place.smem_bytes + row_bytes > BLOCK_SMEM:
        return in_place
    rows = max(1, min(MAX_TILE_ROWS, STAGE_BUDGET // row_bytes))
    return layout(num_groups, num_steps, row_words, n_arrays, rows, store, lanes)


def accumulators(op: str, num_groups: int, width: int, device):
    """``acc`` at the op's identity and ``cnt`` at zero, both f32
    ``[num_groups + 1, width]`` (row ``num_groups`` is the trash group)."""
    init = {"min": float("inf"), "max": float("-inf")}.get(op, 0.0)
    acc = torch.full((num_groups + 1, width), init, dtype=torch.float32, device=device)
    cnt = torch.zeros((num_groups + 1, width), dtype=torch.float32, device=device)
    return acc, cnt


def finish_groups(op: str, acc: torch.Tensor, cnt: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``[G+1, J]`` accumulators -> ``[G, J]`` (the finish of
    ``segment_aggregate``): NaN where a group has no member."""
    acc, cnt = acc[:num_groups], cnt[:num_groups]
    has = cnt > 0
    nan = float("nan")
    if op == "count":
        return torch.where(has, cnt, nan)
    if op == "avg":
        return torch.where(has, acc / torch.clamp(cnt, min=1.0), nan)
    return torch.where(has, acc, nan)


def series_buffer(num_rows: int, j_pad: int, num_steps: int, device) -> torch.Tensor:
    """The store mode's ``[j_pad, num_rows]`` f32 grid before a launch:
    the kernels write steps ``[0, num_steps)``; the padded steps are NaN."""
    out = torch.empty((j_pad, num_rows), dtype=torch.float32, device=device)
    out[num_steps:] = float("nan")
    return out


def run_series(device: torch.device, num_rows: int, gids: torch.Tensor, num_groups: int,
               num_steps: int, plain, launch) -> torch.Tensor:
    """The body of every rung's store-mode wrapper, after its checks: on a
    CPU block the rung's plain per-series values (``plain()``, [S, J_pad])
    through ``series_grid``; on a CUDA block one ``launch(out)`` of the
    kernel in the store mode into a fresh grid from ``series_buffer``."""
    if device.type == "cpu":
        return series_grid(plain(), gids, num_groups, num_steps)
    if device.type != "cuda":
        raise ValueError(f"the range kernels run on cuda or cpu tensors, not {device}")
    out = series_buffer(num_rows, pad_steps(num_steps), num_steps, device)
    launch(out)
    return out


def series_grid(sj: torch.Tensor, gids: torch.Tensor, num_groups: int,
                num_steps: int) -> torch.Tensor:
    """The store mode in plain torch: the ``[S, J_pad]`` per-series grid
    of a rung's plain version -> the kernels' step-major ``[J_pad, S]``,
    rows outside ``[0, num_groups)`` (the trash group of padded rows) and
    steps past ``num_steps`` NaN."""
    real = ((gids >= 0) & (gids < num_groups))[:, None]
    out = torch.where(real, sj, float("nan"))
    out[:, num_steps:] = float("nan")
    return out.T.contiguous()


def mask_steps(out: torch.Tensor, num_steps: int) -> torch.Tensor:
    """NaN in the padded steps past the query's ``num_steps``, which the
    kernels do not compute; the plain versions match them so."""
    out[:, num_steps:] = float("nan")
    return out


def check_aligned(**tensors) -> None:
    """The window-stats kernel stages rows with 16-byte copies and the
    regular kernel reads them two samples per 8-byte load: every row must
    start on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or (t.dim() == 2 and t.shape[1] % 4):
            raise ValueError(f"{name} rows must start on 16-byte boundaries "
                             f"(data_ptr {t.data_ptr():#x}, shape {tuple(t.shape)})")


# -- lane mode (cross-query batching) ------------------------------------------


def lane_accumulators(op: str, lanes: int, num_groups: int, width: int, device):
    """``acc`` and ``cnt`` ``[lanes, num_groups + 1, width]``: each lane's
    accumulators of ``accumulators``."""
    init = {"min": float("inf"), "max": float("-inf")}.get(op, 0.0)
    acc = torch.full((lanes, num_groups + 1, width), init, dtype=torch.float32, device=device)
    cnt = torch.zeros((lanes, num_groups + 1, width), dtype=torch.float32, device=device)
    return acc, cnt


def finish_lanes(op: str, acc: torch.Tensor, cnt: torch.Tensor, lanes) -> list:
    """Each lane's ``[G_l, J_pad]`` values from its slice of the lane
    accumulators: ``finish_groups`` over its own G_l groups, NaN past its
    own ``num_steps``. ``lanes`` are ``(grouping, G, q, params)``."""
    return [mask_steps(finish_groups(op, acc[i], cnt[i], G), params.num_steps)
            for i, (_g, G, _q, params) in enumerate(lanes)]


def lanes_plain(series_of_window, op: str, lanes, u_of_lane) -> list:
    """The lane mode in plain torch, from the rung's solo plain version:
    ``series_of_window(u)`` (the [S_pad, J_pad] per-series values of unique
    window u) once per window, then each lane's solo epilogue (the
    ``("agg", op)`` segment aggregate over its own group ids, NaN past its
    own ``num_steps``): bit-equal to the lanes' solo runs by construction."""
    from .aggregations import apply_epilogue

    grids: dict = {}
    out = []
    for (gids, G, _q, params), u in zip(lanes, u_of_lane):
        if u not in grids:
            grids[u] = series_of_window(u)
        out.append(mask_steps(apply_epilogue(grids[u], ("agg", op), gids, G), params.num_steps))
    return out


def lane_series_buffer(windows: int, num_rows: int, j_pad: int, num_steps: int,
                       device) -> torch.Tensor:
    """The store mode's ``[windows, j_pad, num_rows]`` grids of a lane-mode
    launch, one ``series_buffer`` per unique window."""
    out = torch.empty((windows, j_pad, num_rows), dtype=torch.float32, device=device)
    out[:, num_steps:] = float("nan")
    return out
