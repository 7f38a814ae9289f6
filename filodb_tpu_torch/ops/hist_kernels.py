"""Native-histogram range functions fused with the per-bucket group sum,
and the ``histogram_quantile`` epilogue (counterpart of
``filodb_tpu/ops/hist_kernels.py``; reference format/vectors/Histogram.scala
quantile math :64-130, HistogramQuantileMapper, RateFunctions hist rate
:367).

Native histograms stage as ``[S, T, B]`` blocks of raw cumulative bucket
counts. ``sum by (...) (func(m[w]))`` over them is a per-bucket range
function followed by a per-bucket group sum to ``[G, J, B]``;
``histogram_quantile(q, ...)`` then interpolates over the bucket axis to
``[G, J]``. One kernel, ``filodb_hist_range_aggregate`` of
``csrc/hist_range.cu``, carries both on the card, in one launch:

- ``hist_range_partials``: the range function of every (row, step, bucket)
  reduced straight into ``[G+1, J_pad * B]`` accumulators (``group_acc``),
  over the shared ``[J]`` window bounds of a regular grid (``windows``),
  the shared step table of a near-regular one (``jitter``, a
  ``mxu_jitter.JitterWindowMatrices``; the jitter mode, B1, entry
  ``filodb_hist_range_jitter``: each row's window is the step's certain
  range and the edge slots its deviation ``ts - nominal`` lets in, so no
  search) or bounds searched per series;
- ``hist_range_quantile``: the same launch with the quantile folded in --
  the block that finishes a slice's partials last interpolates them into
  ``[G, J_pad]`` -- returning the quantiles and the partials.

``histogram_quantile_gather`` is the standalone quantile (B7's
``histogram_quantile``) over classic ``le``-labelled bucket series: one
launch of ``filodb_hist_quantile_gather`` per bucket scheme gathers each
group's cumulative counts from the rows of a finished by-(le, ...)
aggregate through an index table and applies the same rule
(``histogram_quantile_gather_plain`` on a CPU tensor); its launches are
counted in ``QUANTILE_LAUNCHES``.

The reference tree over native histograms (ROADMAP A2b) takes two more
entries of the same source. ``hist_range_series`` is the range kernel's
store mode (``filodb_hist_range_series``, K1): every (row, step, bucket)
value written once to a step-major ``[J, B, S]`` grid, no group partials;
a tree leaf's ``run_hist_range_function`` returns its permuted ``[S, J,
B]`` view, which the map phase's segment aggregate reads in place.
``hist_instant`` (``filodb_hist_instant``, K2) computes histogram_quantile
(with the ``even`` variant of histogram_max_quantile_even) or
histogram_fraction for every (row, step) of a plan node's ``[S_g, J,
B_g]`` grids of any strides, in one launch, into a step-major ``[J, sum
S_g]`` buffer. Their launches count in
``SERIES_LAUNCHES`` and ``INSTANT_LAUNCHES``; their plain versions are
``hist_series_plain``, ``histogram_quantile_plain`` and
``histogram_fraction_plain``.

``hist_plan`` lays a launch out (rows per tile, whole-step slices, the
bucket vector width, shared or global partials, shared memory) and
``hist_grid`` sizes its persistent grid; ``hist_buffers`` carves the
slices' arrival counters from the accumulators' zeroed allocation.

On a CPU tensor each entry runs its plain torch version
(``hist_partials_plain``, ``hist_quantile_plain``), which the tests hold
against the JAX package; on a CUDA tensor it launches the kernel or raises.
Steps past the query's ``num_steps`` are not computed: their group sums and
quantiles are NaN.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build
from . import group_acc as GA
from . import mxu_jitter as MJ
from .kernels import pad_steps

# histogram range functions of the fused path ("last" is the plain
# selector's read)
FUSED_HIST_FUNCS = frozenset({
    "rate", "increase", "delta", "sum_over_time", "last", "last_over_time",
})

# the kernel's function codes (csrc/hist_range.cu, enum HFunc)
HIST_FUNC_CODES = {"rate": 0, "increase": 1, "delta": 2, "sum_over_time": 3, "last": 4,
                   "last_over_time": 4}

MAX_THREADS = 384  # threads per block at most (csrc/hist_range.cu MAX_THREADS)
HIST_TILE_ROWS = 16  # rows per tile (fewer when staged ts rows must fit STAGE_BUDGET)
# the store mode's rows per tile: on an H100 its 8 leaves of 12,500 x 111 x
# 12 ran faster at 8 rows than at 16 and 32 (shared bounds) and than at 4
# and 16 (per-series bounds; PERF.md section 6)
SERIES_TILE_ROWS = 8
STAGE_BUDGET = 48 * 1024  # both ts tile buffers of per-series bounds
BOUNDS_BUDGET = 24 * 1024  # the [R, steps] lo/hi/factor table of a tile
MAX_PART_SLICES = 8  # slices that shared [G, steps*B] partials may take, else global

# launches since the last reset: RANGE_LAUNCHES of filodb_hist_range_aggregate,
# FOLDED_QUANTILES of those that carried the quantile epilogue; LAST_PLAN
# is the last launch's HistPlan and LAST_GRID its (blocks per slice, slices)
RANGE_LAUNCHES = 0
JITTER_LAUNCHES = 0  # of RANGE_LAUNCHES, those in the jitter mode (filodb_hist_range_jitter)
FOLDED_QUANTILES = 0
QUANTILE_LAUNCHES = 0  # of filodb_hist_quantile_gather
SERIES_LAUNCHES = 0  # of filodb_hist_range_series (the store mode, K1)
INSTANT_LAUNCHES = 0  # of filodb_hist_instant (K2)
LAST_PLAN = None
LAST_GRID = None
LAST_SERIES_PLAN = None  # the last store-mode launch's HistPlan

# the instant kernel's op codes (csrc/hist_range.cu, enum HOp), and the
# grids one launch takes at most (MAX_GRIDS)
INSTANT_OPS = {"quantile": 0, "quantile_even": 1, "fraction": 2}
MAX_GRIDS = 32

_lib = None
_resident: dict = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' argument types on a built library."""
    fn = lib.filodb_hist_range_aggregate
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 20 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_resident
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_quantile_gather
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.filodb_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_range_series
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_range_jitter
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_jitter_resident
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_instant
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("hist_range"))))
    return _lib


# -- plain versions ------------------------------------------------------------


def _extrap_factor(cnt, tf, tl, out_t, window_ms: int):
    """Prometheus' extrapolation factor (hist_kernels.py:59-77) of windows
    of ``cnt`` samples with first/last timestamps ``tf``/``tl`` (int32 ms)
    ending at ``out_t``; f32, in the kernel's order of operations."""
    f32 = torch.float32
    cnt = cnt.to(f32)
    tf = tf.to(f32) * 1e-3
    tl = tl.to(f32) * 1e-3
    sampled = tl - tf
    range_start = (out_t - window_ms).to(f32) * 1e-3
    range_end = out_t.to(f32) * 1e-3
    dur_start = tf - range_start
    dur_end = range_end - tl
    avg_dur = sampled / torch.clamp(cnt - 1.0, min=1.0)
    thresh = avg_dur * 1.1
    dur_start = torch.where(dur_start >= thresh, avg_dur / 2.0, dur_start)
    dur_end = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)
    return (sampled + dur_start + dur_end) / torch.clamp(sampled, min=1e-30)


def hist_range_plain(func: str, block, params, windows=None, is_delta: bool = False,
                     jitter=None):
    """[S, T, B] histogram block -> [S, J_pad, B] per-bucket range function
    in plain torch: the JAX package's ``_hist_range_shared`` with the
    shared [J] ``windows`` (lo, hi, t_first, t_last) of a regular grid,
    ``_hist_range_jitter`` over the step table of ``jitter`` (a
    ``mxu_jitter.JitterWindowMatrices``: ``hist_jitter_plain``), else its
    ``hist_range_kernel`` with bounds searched per series. Window sums are
    taken in index order inside the window, as the kernel takes them."""
    if func not in FUSED_HIST_FUNCS:
        raise NotImplementedError(f"histogram range function {func!r} is not ported")
    if jitter is not None:
        return hist_jitter_plain(func, block, jitter, params, is_delta)
    vals = block.vals
    S, T, B = vals.shape
    dev = vals.device
    J = pad_steps(params.num_steps)
    i32 = torch.int32
    start_off = int(params.start_ms - block.base_ms)
    window = int(params.window_ms)
    out_t = (start_off + torch.arange(J, dtype=torch.int64, device=dev)
             * int(params.step_ms)).to(i32)
    if windows is not None:
        lo, hi, tf, tl = (w[:J].to(dev) for w in windows)
        factor = _extrap_factor(hi - lo, tf, tl, out_t, window)[None, :]
        lo, hi = lo.long()[None, :].expand(S, J), hi.long()[None, :].expand(S, J)
    else:
        lane = torch.arange(T, device=dev)
        ts = torch.where(lane[None, :] < block.lens[:, None].long(), block.ts, 2**31 - 1)
        q_hi = out_t[None, :].expand(S, J).contiguous()
        hi = torch.searchsorted(ts, q_hi, right=True)
        lo = torch.searchsorted(ts, (q_hi - window).to(i32), right=True)
        tf = torch.gather(ts, 1, lo.clamp(0, T - 1))
        tl = torch.gather(ts, 1, (hi - 1).clamp(0, T - 1))
        factor = _extrap_factor(hi - lo, tf, tl, out_t[None, :], window)
    return _window_values_plain(func, vals, lo, hi, factor, window, is_delta)


def _window_values_plain(func: str, vals, lo, hi, factor, window: int, is_delta: bool):
    """The per-bucket range function of every row's [S, J] windows [lo, hi)
    with their extrapolation ``factor`` (broadcast to [S, J]) -> [S, J, B]:
    the kernel's ``window_values``."""
    S, T, B = vals.shape
    J = lo.shape[1]
    cnt = hi - lo

    def take(idx):  # [S, J] sample positions -> [S, J, B]
        return torch.gather(vals, 1, idx.clamp(0, T - 1)[:, :, None].expand(S, J, B))

    nan = float("nan")
    w_s = torch.tensor(window, dtype=torch.float32, device=vals.device) * 1e-3
    if func in ("last", "last_over_time"):
        return torch.where((cnt > 0)[:, :, None], take(hi - 1), nan)
    if func == "sum_over_time" or (is_delta and func in ("rate", "increase")):
        sm = torch.zeros((S, J, B), dtype=torch.float32, device=vals.device)
        for i in range(int(cnt.max()) if cnt.numel() else 0):
            k = lo + i
            sm = sm + torch.where((k < hi)[:, :, None], take(k), 0.0)
        if func == "rate":
            sm = sm / w_s
        return torch.where((cnt > 0)[:, :, None], sm, nan)
    res = (take(hi - 1) - take(lo)) * factor[:, :, None]
    if func == "rate":
        res = res / w_s
    return torch.where((cnt >= 2)[:, :, None], res, nan)


def jitter_windows_plain(block, wm, window_ms: int):
    """The jitter mode's [S, J_pad] windows ``(lo, hi)`` (int64) and
    extrapolation factors (f32) of a near-regular block over the step table
    of ``wm`` (``mxu_jitter.JitterWindowMatrices``), as the kernel's
    ``jitter_bounds`` computes them: the certain range, each edge slot in
    it where the row's deviation ``ts - nominal`` there passes the slot's
    bound; the boundary times relative to the window's start in f32, in the
    JAX package's order (``_hist_range_jitter``)."""
    d = MJ.step_vectors(wm)
    ts = block.ts
    f32 = torch.float32

    def dev(k):
        return (ts[:, d["idx"][k]].to(torch.int64) - d["nom"][k]).to(f32)

    dKlo, dKhi = dev(MJ.KLO), dev(MJ.KHI)
    in_lo = d["has_klo"] & (dKlo > d["blo_rel"])
    in_hi = d["has_khi"] & (dKhi <= d["ehi_rel"])
    cnt = d["count0"] + in_lo + in_hi
    lo = torch.where(in_lo, d["idx"][MJ.KLO], d["clo"])
    hi = torch.where(in_hi, d["idx"][MJ.KHI] + 1, d["chi"])
    c0 = d["c0pos"]
    klo_t, khi_t = d["Klo_rel"] + dKlo, d["Khi_rel"] + dKhi
    tf_rel = torch.where(in_lo, klo_t, torch.where(c0, d["F0_rel"] + dev(MJ.F0), khi_t))
    tl_rel = torch.where(in_hi, khi_t, torch.where(c0, d["L0_rel"] + dev(MJ.L0), klo_t))
    sampled = (tl_rel - tf_rel) * 1e-3
    dur_start = tf_rel * 1e-3
    dur_end = (torch.tensor(np.float32(window_ms), device=ts.device) - tl_rel) * 1e-3
    avg_dur = sampled / torch.clamp(cnt - 1.0, min=1.0)
    thresh = avg_dur * 1.1
    ds = torch.where(dur_start >= thresh, avg_dur / 2.0, dur_start)
    de = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)
    factor = (sampled + ds + de) / torch.clamp(sampled, min=1e-30)
    return lo, hi, factor


def hist_jitter_plain(func: str, block, wm, params, is_delta: bool = False) -> torch.Tensor:
    """The jitter mode's range function in plain torch: [S, T, B] ->
    [S, J_pad, B] over the windows of ``jitter_windows_plain``."""
    if func not in FUSED_HIST_FUNCS:
        raise NotImplementedError(f"histogram range function {func!r} is not ported")
    lo, hi, factor = jitter_windows_plain(block, wm, int(params.window_ms))
    return _window_values_plain(func, block.vals, lo, hi, factor, int(params.window_ms),
                                is_delta)


def hist_partials_plain(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        windows=None, is_delta: bool = False, jitter=None):
    """The range kernel's function in plain torch: ``hist_range_plain`` ->
    the per-bucket sum over the flattened [S, J_pad * B] grid into
    ``(acc, cnt)`` [G+1, J_pad * B] (NaN is absence; padded rows go to the
    trash group G), with the steps past ``params.num_steps`` empty."""
    sjb = hist_range_plain(func, block, params, windows, is_delta, jitter)
    S, J, B = sjb.shape
    flat = sjb.reshape(S, J * B)
    valid = ~torch.isnan(flat)
    zeros = torch.zeros((num_groups + 1, J * B), dtype=flat.dtype, device=flat.device)
    acc = zeros.index_add(0, gids, torch.where(valid, flat, 0.0))
    cnt = zeros.index_add(0, gids, valid.to(flat.dtype))
    acc[:, params.num_steps * B:] = 0.0
    cnt[:, params.num_steps * B:] = 0.0
    return acc, cnt


def histogram_quantile_plain(q: float, buckets: torch.Tensor, les: torch.Tensor,
                             even: bool = False) -> torch.Tensor:
    """Prometheus histogram_quantile over cumulative bucket counts [..., B]
    with bounds ``les`` [B] (les[-1] = +inf), line for line the JAX
    package's ``histogram_quantile``: linear interpolation in the first
    bucket whose count reaches ``q`` x the total (``even``: over the
    bucket's count + 1 positions, histogram_max_quantile_even); the +Inf
    bucket returns the highest finite bound; a first bound <= 0 has no
    lower bound (-inf: the bucket's upper bound is returned); a total that
    is not positive and finite gives NaN; q < 0 gives -inf and q > 1
    +inf."""
    f32 = torch.float32
    B = buckets.shape[-1]
    les = les.to(device=buckets.device, dtype=f32)
    total = buckets[..., -1]
    ok = (total > 0) & torch.isfinite(total)
    qv = torch.tensor(q, dtype=f32, device=buckets.device)
    rank = torch.clamp(qv, 0.0, 1.0) * total
    meets = buckets >= rank[..., None]
    idx = torch.argmax(meets.to(torch.int8), dim=-1)
    idx = torch.where(meets.any(-1), idx, B - 1)
    below = torch.clamp(idx - 1, min=0)
    c_hi = torch.gather(buckets, -1, idx[..., None])[..., 0]
    c_lo = torch.where(idx > 0, torch.gather(buckets, -1, below[..., None])[..., 0], 0.0)
    le_hi = les[idx]
    first_lo = torch.where(les[0] > 0, 0.0, float("-inf"))
    le_lo = torch.where(idx > 0, les[below], first_lo)
    highest_finite = les[B - 2] if B >= 2 else les[0]
    denom = (c_hi - c_lo) + 1.0 if even else c_hi - c_lo
    frac = (rank - c_lo) / torch.clamp(denom, min=1e-30)
    val = le_lo + (le_hi - le_lo) * frac
    val = torch.where(idx == B - 1, highest_finite, val)
    val = torch.where(torch.isneginf(le_lo), le_hi, val)
    out = torch.where(ok, val, float("nan"))
    if q < 0:
        out = torch.full_like(out, float("-inf"))
    if q > 1:
        out = torch.full_like(out, float("inf"))
    return out


def histogram_fraction_plain(lower: float, upper: float, buckets: torch.Tensor,
                             les: torch.Tensor) -> torch.Tensor:
    """promql histogram_fraction(lower, upper, .) over cumulative bucket
    counts [..., B] with bounds ``les`` [B] (les[-1] = +inf), line for line
    the JAX package's ``histogram_fraction``: each bound's cumulative count
    interpolated linearly in the first bucket whose bound reaches it
    (``searchsorted``, clipped to the top bucket; below a first bound > 0
    from 0, else from -inf with the whole bucket), the difference over the
    total clipped to [0, 1]; NaN where the total is not positive. The
    bounds are f32, as the JAX package casts them."""
    f32 = torch.float32
    B = buckets.shape[-1]
    dev = buckets.device
    les = les.to(device=dev, dtype=f32)
    first_lo = torch.where(les[0] > 0, 0.0, float("-inf"))

    def cum_at(x: float):
        xv = torch.tensor(x, dtype=f32, device=dev)
        xb = min(int((les < xv).sum()), B - 1)  # searchsorted, side left
        c_hi = buckets[..., xb]
        c_lo = buckets[..., xb - 1] if xb > 0 else torch.zeros_like(c_hi)
        le_hi = les[xb]
        le_lo = les[xb - 1] if xb > 0 else first_lo
        width = le_hi - le_lo
        w = torch.where(torch.isfinite(width), (xv - le_lo) / torch.clamp(width, min=1e-30), 1.0)
        return c_lo + (c_hi - c_lo) * torch.clamp(w, 0.0, 1.0)

    total = buckets[..., -1]
    frac = (cum_at(float(np.float32(upper))) - cum_at(float(np.float32(lower)))) / torch.clamp(
        total, min=1e-30)
    return torch.where(total > 0, torch.clamp(frac, 0.0, 1.0), float("nan"))


def hist_quantile_plain(q: float, acc: torch.Tensor, cnt: torch.Tensor, num_groups: int,
                        les: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The quantile kernel's function in plain torch: the group finish of
    ``(acc, cnt)`` to [G, J_pad, B] (NaN without a member), then
    ``histogram_quantile_plain``; NaN past ``num_steps``."""
    B = les.shape[0]
    buckets = GA.finish_groups("sum", acc, cnt, num_groups).reshape(num_groups, -1, B)
    return GA.mask_steps(histogram_quantile_plain(q, buckets, les), num_steps)


# -- wrappers ------------------------------------------------------------------


def _check(name: str, t, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@dataclass(frozen=True)
class HistPlan:
    """One range launch's layout: ``rows`` per tile, ``steps`` per slice
    (``slices`` slices of whole steps, each with its own blocks and arrival
    counter), buckets fetched ``vec`` at a time, ``threads`` per block,
    ``[G, steps * B]`` group partials in shared memory or not, ts rows
    staged in shared memory or searched in place, and the dynamic shared
    memory that takes (``csrc/hist_range.cu`` ``smem_words``, checked by
    the C entry)."""

    rows: int
    steps: int
    slices: int
    vec: int
    threads: int
    shared: bool
    staged: bool
    smem_bytes: int
    store: bool = False  # the store mode (per-series values, no partials)

    @property
    def partials(self) -> str:
        return "store" if self.store else "shared" if self.shared else "global"


def hist_smem_bytes(G: int, B: int, steps: int, rows: int, T: int, shared_bounds: bool,
                    shared: bool, staged: bool) -> int:
    """Dynamic shared memory of a launch: the ``[G, steps * B]`` acc/cnt
    partials (``shared``), ``rows`` gids, the lo/hi/factor table (``[steps]``
    on shared bounds, ``[rows, steps]`` per series) and both ts tile buffers
    (``staged``), each rounded up to 16 bytes."""
    part = _round4(2 * G * steps * B) if shared else 0
    nb = (1 if shared_bounds else rows) * steps
    return 4 * (part + _round4(rows) + _round4(3 * nb) + (2 * rows * T if staged else 0))


@functools.lru_cache(maxsize=256)
def hist_plan(T: int, num_steps: int, B: int, num_groups: int,
              shared_bounds: bool, store: bool = False, jitter: bool = False) -> HistPlan:
    """The range kernel's layout for rows of ``T`` samples of ``B`` buckets,
    ``num_steps`` steps and ``num_groups`` groups.

    - Buckets are fetched ``vec`` = 4, 2 or 1 at a time, the widest that
      divides B (a sample's B floats are contiguous).
    - Per-series bounds stage each tile's ts rows in shared memory, both
      buffers within ``STAGE_BUDGET`` (at most ``HIST_TILE_ROWS`` rows), or
      search them in place when one row does not fit; shared bounds read
      ``HIST_TILE_ROWS`` rows per tile.
    - Steps are cut into slices of whole steps so that a tile's lo/hi/factor
      table fits ``BOUNDS_BUDGET`` and, while at most ``MAX_PART_SLICES``
      slices do it, the ``[G, steps * B]`` partials fit
      ``group_acc.PARTIALS_BUDGET``; else the partials go to global atomics.
      Slices are balanced: ``steps = ceil(J / slices)``.
    - A block has one thread per column vector of its slice (``steps * B /
      vec``), in as few passes of at most ``MAX_THREADS`` as cover them,
      rounded up to whole warps: no warp idles through a partial pass.
    - ``jitter`` (the jitter mode): per-series bounds tables read from the
      step table, so no ts rows are staged and tiles take
      ``HIST_TILE_ROWS`` rows.
    - ``store`` (the store mode, ``num_groups`` 1): at most
      ``SERIES_TILE_ROWS`` rows per tile and no partials, so slices only
      keep the bounds table within its budget, and a block's threads cover
      the (column vector, row) items of a tile the same way."""
    J = num_steps
    vec = 4 if B % 4 == 0 else 2 if B % 2 == 0 else 1
    row_bytes = 2 * T * 4
    staged = not shared_bounds and not jitter and row_bytes <= STAGE_BUDGET
    most = SERIES_TILE_ROWS if store else HIST_TILE_ROWS
    rows = max(1, min(most, STAGE_BUDGET // row_bytes)) if staged else most
    cap = max(1, BOUNDS_BUDGET // (12 * (1 if shared_bounds else rows)))
    step_part = 2 * num_groups * B * 4  # one step's shared partials
    part_cap = GA.PARTIALS_BUDGET // step_part
    shared = not store and part_cap >= 1 and -(-J // min(part_cap, J)) <= MAX_PART_SLICES
    if shared:
        cap = min(cap, part_cap)
    slices = -(-J // min(cap, J))
    steps = -(-J // slices)
    items = steps * (B // vec) * (rows if store else 1)
    per_pass = -(-items // -(-items // MAX_THREADS))
    threads = -(-per_pass // 32) * 32
    return HistPlan(rows, steps, slices, vec, threads, shared, staged,
                    hist_smem_bytes(num_groups, B, steps, rows, T, shared_bounds, shared, staged),
                    store)


def hist_grid(plan: HistPlan, S: int, resident: int) -> tuple[int, int]:
    """The persistent grid of a launch over ``S`` rows: (blocks per slice,
    slices). The ``resident`` blocks that fit on the card at once are shared
    among the slices, at least one each and no more than a slice's tiles;
    each slice's arrival counter counts its blocks."""
    tiles = -(-S // plan.rows)
    return max(1, min(tiles, resident // plan.slices)), plan.slices


def hist_buffers(num_groups: int, width: int, slices: int, device):
    """``acc`` and ``cnt`` ([G+1, width] f32 zeros) and the slices' arrival
    counters (``slices`` int32 zeros) carved from one zeroed allocation, so
    that the counters cost no launch of their own; the kernel leaves them
    at zero."""
    n = (num_groups + 1) * width
    buf = torch.zeros(2 * n + _round4(slices), dtype=torch.float32, device=device)
    acc = buf[:n].view(num_groups + 1, width)
    cnt = buf[n:2 * n].view(num_groups + 1, width)
    return acc, cnt, buf[2 * n:2 * n + slices].view(torch.int32)


def _check_block(func: str, block, gids: torch.Tensor, params, windows, jitter=None):
    if func not in FUSED_HIST_FUNCS:
        raise NotImplementedError(f"histogram range function {func!r} is not ported")
    vals = block.vals
    if vals.dim() != 3:
        raise ValueError(f"vals must be [S, T, B], got {tuple(vals.shape)}")
    S, T, B = vals.shape
    dev = vals.device
    _check("vals", vals, torch.float32, (S, T, B), dev)
    _check("gids", gids, torch.int64, (S,), dev)
    j_pad = pad_steps(params.num_steps)
    if windows is not None:
        for name, w in zip(("lo", "hi", "t_first", "t_last"), windows):
            _check(name, w, torch.int32, (j_pad,), dev)
    elif jitter is not None:
        if not jitter.ok:
            raise ValueError("the jitter window structure declined this window (ok false)")
        _check("steps", jitter.steps, torch.int32, (j_pad, MJ.STEP_WORDS), dev)
        _check("ts", block.ts, torch.int32, (S, T), dev)
    else:
        _check("ts", block.ts, torch.int32, (S, T), dev)
        _check("lens", block.lens, torch.int32, (S,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the histogram range kernel runs on cuda or cpu tensors, not {dev}")
    return dev, j_pad, B


def hist_range_partials(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        windows=None, is_delta: bool = False, jitter=None):
    """``sum by (...) (func(m[w]))`` over a [S, T, B] histogram block ->
    ``(acc, cnt)`` [G+1, J_pad * B] group partials on the block's device
    (bucket b of step j at column j * B + b; group G is the trash group of
    padded rows). ``windows`` are the shared [J_pad] bounds (lo, hi,
    t_first, t_last) of a regular grid, ``jitter`` the window structure
    (``mxu_jitter.JitterWindowMatrices``) of a near-regular one, else
    bounds are searched per series. A CUDA block makes one launch of the
    range kernel (and raises if the launch fails); a CPU block runs
    ``hist_partials_plain``."""
    dev, j_pad, B = _check_block(func, block, gids, params, windows, jitter)
    if dev.type == "cpu":
        return hist_partials_plain(func, block, gids, num_groups, params, windows, is_delta,
                                   jitter)
    plan = hist_plan(block.vals.shape[1], params.num_steps, B, num_groups, windows is not None,
                     jitter=jitter is not None)
    acc, cnt, arrivals = hist_buffers(num_groups, j_pad * B, plan.slices, dev)
    _launch_range(func, block, gids, num_groups, params, windows, is_delta, acc, cnt,
                  jitter=jitter)
    return acc, cnt


def hist_range_quantile(q: float, func: str, block, gids: torch.Tensor, num_groups: int,
                        params, les: torch.Tensor, windows=None, is_delta: bool = False,
                        jitter=None):
    """``histogram_quantile(q, sum by (...) (func(m[w])))`` over a [S, T, B]
    histogram block with bounds ``les`` (f32 [B], les[-1] = +inf) -> ``(out,
    acc, cnt)``: the [G, J_pad] quantiles (NaN past ``num_steps``) and the
    group partials they were interpolated from. A CUDA block makes one
    launch of the range kernel with the quantile folded in (and raises if
    the launch fails); a CPU block runs ``hist_partials_plain`` and
    ``hist_quantile_plain``."""
    dev, j_pad, B = _check_block(func, block, gids, params, windows, jitter)
    _check("les", les, torch.float32, (B,), dev)
    if dev.type == "cpu":
        acc, cnt = hist_partials_plain(func, block, gids, num_groups, params, windows, is_delta,
                                       jitter)
        return hist_quantile_plain(q, acc, cnt, num_groups, les, params.num_steps), acc, cnt
    plan = hist_plan(block.vals.shape[1], params.num_steps, B, num_groups, windows is not None,
                     jitter=jitter is not None)
    acc, cnt, arrivals = hist_buffers(num_groups, j_pad * B, plan.slices, dev)
    out = torch.full((num_groups, j_pad), float("nan"), dtype=torch.float32, device=dev)
    _launch_range(func, block, gids, num_groups, params, windows, is_delta, acc, cnt,
                  quantile=(q, les, out, arrivals), jitter=jitter)
    return out, acc, cnt


def hist_series_plain(func: str, block, gids: torch.Tensor, params, windows=None,
                      is_delta: bool = False) -> torch.Tensor:
    """The store mode's function in plain torch: ``hist_range_plain`` at
    the first ``params.num_steps`` steps, the rows whose ``gids`` entry is
    not 0 NaN, as the step-major [J, B, S] grid."""
    sjb = hist_range_plain(func, block, params, windows, is_delta)[:, : params.num_steps]
    sjb = torch.where((gids == 0)[:, None, None], sjb, float("nan"))
    return sjb.permute(1, 2, 0).contiguous()


def hist_range_series(func: str, block, gids: torch.Tensor, params, windows=None,
                      is_delta: bool = False) -> torch.Tensor:
    """``func(m[w])`` of every series of a [S, T, B] histogram block, the
    store mode of the range kernel: the step-major [J, B, S] grid (J =
    ``params.num_steps``; bucket b of step j of row s at [j, b, s]), the
    rows whose ``gids`` entry (int64 [S]) is not 0 -- padding -- NaN.
    ``windows`` are the shared [J_pad] bounds of a regular grid, else
    bounds are searched per series. A CUDA block makes one launch of
    ``filodb_hist_range_series`` (and raises if the launch fails), counted
    in ``SERIES_LAUNCHES``; a CPU block runs ``hist_series_plain``."""
    dev, _, B = _check_block(func, block, gids, params, windows)
    if dev.type == "cpu":
        return hist_series_plain(func, block, gids, params, windows, is_delta)
    S = block.vals.shape[0]
    out = torch.empty((params.num_steps, B, S), dtype=torch.float32, device=dev)
    _launch_series(func, block, gids, params, windows, is_delta, out)
    return out


def _launch_series(func: str, block, gids, params, windows, is_delta: bool,
                   out: torch.Tensor, lib=None) -> None:
    """One launch of the store mode into ``out`` ([J, B, ld] f32, ld >= S;
    every (step, bucket, row) below (J, B, S) is written) in ``hist_plan``'s
    layout with ``store``; ``lib`` (default the built library) lets a sweep
    time patched builds. Raises if the launch fails."""
    global SERIES_LAUNCHES, LAST_SERIES_PLAN
    S, T, B = block.vals.shape
    dev = block.vals.device
    shared_bounds = windows is not None
    plan = hist_plan(T, params.num_steps, B, 1, shared_bounds, store=True)
    if out.dim() != 3 or out.shape[:2] != (params.num_steps, B) or out.stride(1) < S or (
            out.stride(2) != 1 or out.stride(0) != B * out.stride(1)):
        raise ValueError(f"out must be a [J, B, ld >= {S}] grid, got {tuple(out.shape)} "
                         f"strides {out.stride()}")
    if shared_bounds:
        lo, hi, tf, tl = (w.data_ptr() for w in windows)
        ts = lens = None
    else:
        lo = hi = tf = tl = None
        ts, lens = block.ts.data_ptr(), block.lens.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = (lib or _load()).filodb_hist_range_series(
            ts, block.vals.data_ptr(), lens, gids.data_ptr(), lo, hi, tf, tl,
            S, T, B, params.num_steps, int(params.start_ms - block.base_ms),
            int(params.step_ms), int(params.window_ms), HIST_FUNC_CODES[func], int(is_delta),
            int(shared_bounds), plan.rows, plan.steps, plan.vec, int(plan.staged), plan.threads,
            plan.smem_bytes, out.data_ptr(), out.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"hist_range_series kernel launch failed: cudaError {err}")
    SERIES_LAUNCHES += 1
    LAST_SERIES_PLAN = plan


def run_hist_range_function(func: str, block, params, is_delta: bool = False) -> torch.Tensor:
    """A tree leaf's histogram range function (the JAX package's
    ``run_hist_range_function``): [S, J, B] per-series bucket values (J =
    ``params.num_steps``, the padded rows NaN), the permuted view of the
    store mode's step-major [J, B, S] grid (``hist_range_series``: one
    launch), over the shared bounds of a regular block
    (``aggregations.hist_variant``) or bounds searched per series."""
    from . import aggregations as AGG

    windows = (AGG._hist_shared_windows(block, params, pad_steps(params.num_steps))
               if AGG.hist_variant(block) == "hist_shared" else None)
    grid = hist_range_series(func, block, AGG.zero_gids(block), params, windows, is_delta)
    return grid.permute(2, 0, 1)


def hist_instant(op: str, hists: list, les: list, q: float = 0.0, lower: float = 0.0,
                 upper: float = 0.0) -> list:
    """The instant histogram functions of a plan node's grids: each of
    ``hists`` a [S_g, J, B_g] f32 grid of bucket values (any strides, one J
    for all) with its bounds in ``les`` (f32 [B_g] on its device, the last
    +inf) -> a [S_g, J] f32 grid each: ``quantile`` histogram_quantile(q,
    .), ``quantile_even`` the same over count + 1 positions, ``fraction``
    histogram_fraction(lower, upper, .). On the card the grids take one
    launch of ``filodb_hist_instant`` (per ``MAX_GRIDS`` of them) into one
    step-major [J, sum S_g] buffer, counted in ``INSTANT_LAUNCHES``, each
    answer a transposed view of its columns; it raises if the launch fails.
    On the CPU each grid runs ``histogram_quantile_plain`` /
    ``histogram_fraction_plain``."""
    global INSTANT_LAUNCHES
    if op not in INSTANT_OPS:
        raise ValueError(f"unknown instant histogram op {op!r} (known: {sorted(INSTANT_OPS)})")
    if not hists or len(hists) != len(les):
        raise ValueError(f"{len(hists)} grids with {len(les)} bucket bounds")
    dev, J = hists[0].device, hists[0].shape[1] if hists[0].dim() == 3 else -1
    for h, b in zip(hists, les):
        if h.dim() != 3 or h.dtype != torch.float32 or h.shape[1] != J:
            raise ValueError(f"hists must be [S, {J}, B] float32 tensors, got "
                             f"{tuple(h.shape)} {h.dtype}")
        if h.device != dev:
            raise ValueError(f"hist is on {h.device}, not {dev}")
        _check("les", b, torch.float32, (h.shape[2],), dev)
    if dev.type == "cpu":
        if op == "fraction":
            return [histogram_fraction_plain(lower, upper, h, b) for h, b in zip(hists, les)]
        return [histogram_quantile_plain(q, h, b, even=op == "quantile_even")
                for h, b in zip(hists, les)]
    if dev.type != "cuda":
        raise ValueError(f"hist_instant runs on cuda or cpu tensors, not {dev}")
    row0 = np.concatenate([[0], np.cumsum([h.shape[0] for h in hists])]).astype(np.int64)
    out = torch.empty((J, int(row0[-1])), dtype=torch.float32, device=dev)
    lib = _load() if out.numel() else None
    for g0 in range(0, len(hists) if out.numel() else 0, MAX_GRIDS):
        part = hists[g0: g0 + MAX_GRIDS]
        n = len(part)
        if row0[g0 + n] == row0[g0]:
            continue  # no rows: no launch
        ptrs = np.array([h.data_ptr() for h in part], dtype=np.uint64)
        les_ptrs = np.array([b.data_ptr() for b in les[g0: g0 + n]], dtype=np.uint64)
        strides = np.array([h.stride() for h in part], dtype=np.int64).reshape(-1)
        buckets = np.array([h.shape[2] for h in part], dtype=np.int32)
        rows = (row0[g0: g0 + n + 1] - row0[g0]).astype(np.int64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.filodb_hist_instant(
                ptrs.ctypes.data, strides.ctypes.data, les_ptrs.ctypes.data, buckets.ctypes.data,
                rows.ctypes.data, n, J, INSTANT_OPS[op], float(q), float(lower), float(upper),
                out[:, int(row0[g0]):].data_ptr(), out.stride(0), stream)
        if err != 0:
            raise RuntimeError(f"hist_instant kernel launch failed: cudaError {err}")
        INSTANT_LAUNCHES += 1
    return [out[:, int(a): int(b)].T for a, b in zip(row0[:-1], row0[1:])]


def resident_blocks(plan: HistPlan, shared_bounds: bool, device, lib=None,
                    jitter: bool = False) -> int:
    """Blocks of the plan's kernel variant (``jitter``: the jitter mode's)
    that fit on the card at once (asked once per device, variant and shared
    memory)."""
    lib = lib or _load()
    key = (str(device), id(lib), shared_bounds, jitter, plan.shared, plan.staged, plan.vec,
           plan.smem_bytes, plan.threads)
    if key not in _resident:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            if jitter:
                err = lib.filodb_hist_jitter_resident(int(plan.shared), plan.vec,
                                                      plan.smem_bytes, plan.threads,
                                                      ctypes.byref(n))
            else:
                err = lib.filodb_hist_resident(int(shared_bounds), int(plan.shared),
                                               int(plan.staged), plan.vec, plan.smem_bytes,
                                               plan.threads, ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError(f"hist_range occupancy query failed: cudaError {err}")
        _resident[key] = n.value
    return _resident[key]


def _launch_range(func: str, block, gids, num_groups: int, params, windows, is_delta: bool,
                  acc: torch.Tensor, cnt: torch.Tensor, quantile=None, plan=None,
                  lib=None, jitter=None) -> None:
    """One launch of the range kernel into ``acc``/``cnt`` ([G+1, J_pad * B],
    zeros); with ``quantile`` = (q, les, out, arrivals) the quantile epilogue
    runs in the same launch into ``out`` [G, J_pad] (``arrivals``: one zeroed
    int32 counter per slice). ``plan`` (default ``hist_plan``'s) and ``lib``
    (default the built library) let a layout sweep time other layouts and
    patched builds; ``jitter`` (a ``mxu_jitter.JitterWindowMatrices``) takes
    the jitter mode (``filodb_hist_range_jitter``). Raises if the launch
    fails."""
    global RANGE_LAUNCHES, JITTER_LAUNCHES, FOLDED_QUANTILES, LAST_PLAN, LAST_GRID
    S, T, B = block.vals.shape
    dev = block.vals.device
    shared_bounds = windows is not None
    plan = plan or hist_plan(T, params.num_steps, B, num_groups, shared_bounds,
                             jitter=jitter is not None)
    lib = lib or _load()
    grid = hist_grid(plan, S, resident_blocks(plan, shared_bounds, dev, lib,
                                              jitter=jitter is not None))
    q, les, out, arrivals = quantile if quantile is not None else (0.0, None, None, None)
    if quantile is not None and arrivals.numel() < plan.slices:
        raise ValueError(f"{arrivals.numel()} arrival counters for {plan.slices} slices")
    if jitter is not None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.filodb_hist_range_jitter(
                block.ts.data_ptr(), block.vals.data_ptr(), gids.data_ptr(),
                jitter.steps.data_ptr(), S, T, B, params.num_steps, acc.shape[1], num_groups,
                int(params.window_ms), HIST_FUNC_CODES[func], int(is_delta), plan.rows,
                plan.steps, plan.vec, int(plan.shared), plan.threads, grid[0],
                plan.smem_bytes, acc.data_ptr(), cnt.data_ptr(), int(quantile is not None),
                float(q), les.data_ptr() if les is not None else None,
                out.data_ptr() if out is not None else None,
                out.shape[1] if out is not None else 0,
                arrivals.data_ptr() if arrivals is not None else None, stream)
        if err != 0:
            raise RuntimeError(f"hist_range_jitter kernel launch failed: cudaError {err}")
        RANGE_LAUNCHES += 1
        JITTER_LAUNCHES += 1
        FOLDED_QUANTILES += quantile is not None
        LAST_PLAN, LAST_GRID = plan, grid
        return
    # the bounds' source: the shared [J] windows, or each row's ts and lens
    if shared_bounds:
        lo, hi, tf, tl = (w.data_ptr() for w in windows)
        ts = lens = None
    else:
        lo = hi = tf = tl = None
        ts, lens = block.ts.data_ptr(), block.lens.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.filodb_hist_range_aggregate(
            ts, block.vals.data_ptr(), lens, gids.data_ptr(), lo, hi, tf, tl,
            S, T, B, params.num_steps, acc.shape[1], num_groups,
            int(params.start_ms - block.base_ms), int(params.step_ms), int(params.window_ms),
            HIST_FUNC_CODES[func], int(is_delta), int(shared_bounds), plan.rows, plan.steps,
            plan.vec, int(plan.shared), int(plan.staged), plan.threads, grid[0], plan.smem_bytes,
            acc.data_ptr(), cnt.data_ptr(), int(quantile is not None), float(q),
            les.data_ptr() if les is not None else None,
            out.data_ptr() if out is not None else None,
            out.shape[1] if out is not None else 0,
            arrivals.data_ptr() if arrivals is not None else None, stream,
        )
    if err != 0:
        raise RuntimeError(f"hist_range_aggregate kernel launch failed: cudaError {err}")
    RANGE_LAUNCHES += 1
    FOLDED_QUANTILES += quantile is not None
    LAST_PLAN, LAST_GRID = plan, grid


def hist_quantile(q: float, acc: torch.Tensor, cnt: torch.Tensor, num_groups: int,
                  les: torch.Tensor, num_steps: int) -> torch.Tensor:
    """``histogram_quantile(q, ...)`` of CPU group partials from
    ``hist_range_partials`` over the bounds ``les`` (f32 [B]) -> [G, J_pad],
    NaN past ``num_steps`` (``hist_quantile_plain``). On the card the
    quantile runs inside the range launch (``hist_range_quantile``), so a
    CUDA tensor raises."""
    dev = acc.device
    B = les.shape[0] if les.dim() == 1 else -1
    if B < 1 or acc.dim() != 2 or acc.shape[1] % B:
        raise ValueError(f"acc {tuple(acc.shape)} does not hold buckets of les {tuple(les.shape)}")
    _check("acc", acc, torch.float32, (num_groups + 1, acc.shape[1]), dev)
    _check("cnt", cnt, torch.float32, tuple(acc.shape), dev)
    _check("les", les, torch.float32, (B,), dev)
    if dev.type != "cpu":
        raise ValueError(f"hist_quantile takes cpu tensors, not {dev}: on the card the "
                         "quantile is folded into the range launch (hist_range_quantile)")
    return hist_quantile_plain(q, acc, cnt, num_groups, les, num_steps)


def histogram_quantile_gather_plain(q: float, part: torch.Tensor, table: torch.Tensor,
                                    les: torch.Tensor, num_steps: int) -> torch.Tensor:
    """[G, num_steps]: ``histogram_quantile_plain`` over the cumulative
    counts of each group gathered from the rows ``table[g, :]`` (int32
    [G, B]; < 0 reads NaN) of the finished partials ``part`` [*, ld]."""
    idx = table.to(torch.int64)
    rows = part[idx.clamp(min=0), :num_steps]  # [G, B, J]
    rows = torch.where((idx >= 0)[:, :, None], rows, float("nan"))
    return histogram_quantile_plain(q, rows.permute(0, 2, 1), les)


def check_gather_table(table: torch.Tensor, rows: torch.Tensor, les: torch.Tensor) -> None:
    """The checks of one bucket scheme's gather table (``table`` int32 [G,
    B], ``rows`` int32 [G], ``les`` f32 [B], contiguous, on one device),
    made once where the table is built (``transformers.classic_pivot``,
    memoized with it) rather than on every launch."""
    G, B = table.shape if table.dim() == 2 else (-1, -1)
    if G < 0 or B < 1:
        raise ValueError(f"table must be [G, B], got {tuple(table.shape)}")
    _check("table", table, torch.int32, (G, B), table.device)
    _check("rows", rows, torch.int32, (G,), table.device)
    _check("les", les, torch.float32, (B,), table.device)


def histogram_quantile_gather(q: float, part: torch.Tensor, table: torch.Tensor,
                              rows: torch.Tensor, les: torch.Tensor, num_steps: int,
                              out: torch.Tensor) -> torch.Tensor:
    """``histogram_quantile(q, .)`` of the classic bucket groups of one
    bucket scheme: group g's counts are the rows ``table[g, :]`` (int32
    [G, B], le-ascending) of the finished by-(le, ...) partials ``part``
    (f32 [*, ld], NaN where a group had no member), its bounds ``les``
    (f32 [B], the last +inf); the quantiles go to ``out[rows[g],
    :num_steps]`` (``rows`` int32 [G]). The three come checked by
    ``check_gather_table`` where they were built (they are memoized with
    the pivot); each call checks ``part`` and ``out``. A CUDA tensor makes
    one launch of the kernel; a CPU tensor runs
    ``histogram_quantile_gather_plain``. Returns ``out``."""
    global QUANTILE_LAUNCHES
    dev = table.device
    G, B = table.shape
    _check("part", part, torch.float32, tuple(part.shape), dev)
    _check("out", out, torch.float32, tuple(out.shape), dev)
    if part.dim() != 2 or out.dim() != 2 or min(part.shape[1], out.shape[1]) < num_steps:
        raise ValueError(f"part {tuple(part.shape)} / out {tuple(out.shape)} hold fewer than "
                         f"{num_steps} steps")
    if G == 0:
        return out
    if dev.type == "cpu":
        out[rows.to(torch.int64), :num_steps] = histogram_quantile_gather_plain(
            q, part, table, les, num_steps)
        return out
    if dev.type != "cuda":
        raise ValueError(f"histogram_quantile_gather runs on cuda or cpu tensors, not {dev}")
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.filodb_hist_quantile_gather(
            part.data_ptr(), part.shape[1], table.data_ptr(), rows.data_ptr(), les.data_ptr(),
            G, B, int(num_steps), float(q), out.data_ptr(), out.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"hist_quantile_gather kernel launch failed: cudaError {err}")
    QUANTILE_LAUNCHES += 1
    return out


def empty_launch(G: int, num_steps: int, device) -> None:
    """An empty kernel over the blocks a gather of G groups x ``num_steps``
    steps launches, on ``device``'s current stream: the card's floor for a
    launch made as the gather's is (ctypes, the same stream), timed beside
    it. Not counted anywhere."""
    lib = _load()
    with torch.cuda.device(device):
        err = lib.filodb_empty_launch(G, int(num_steps),
                                      torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
