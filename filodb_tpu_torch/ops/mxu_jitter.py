"""Near-regular grid range functions: the jitter and masked rungs
(counterpart of ``filodb_tpu/ops/mxu_jitter.py``; B6).

Real scrape timestamps jitter around their interval, and some scrapes are
missed. Staging classes such blocks ``jitter`` (every series has the same
sample count, each sample within ``maxdev`` of a shared nominal grid,
``2 * maxdev`` below the smallest interval) or ``holes`` (the same with
missed scrapes: the slot-aligned ``staging.MaskedGrid`` sidecar). For a
window ``(b, e]`` the slots with nominal time in ``(b + maxdev, e -
maxdev]`` are in it for every series (the certain range ``[clo, chi)``),
and at most one slot per edge is uncertain (``klo``, ``khi``), in the
window for a series when its deviation passes the edge. The window
structure (``JitterWindowMatrices``) is built once per block and query grid
on the host, exactly as the JAX package builds it; it declines (``ok``
false) when the window is not wider than ``2 * maxdev``, and the ladders
then take the window-stats or general rung.

On a CUDA tensor the wrappers launch ``csrc/jitter_range.cu`` (variant
JITTER or MASKED, aggregate or store mode); on a CPU tensor they run the
plain torch versions below, which follow the JAX kernels' gather form
branch by branch. The jitter rung takes each deviation as ``ts -
nominal_ts`` (int32, exact), which equals the JAX package's f32
``ts_dev``; the masked rung reads validity and deviations from the
sidecar's time fills (the JAX package's lean gather plan), so the card
holds only ``staging.MASKED_PLANES``. min/max scan the certain range, which
equals the JAX package's 16-wide tile hierarchy (a minimum is exact).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..singleflight import memo_on
from . import cuda_build
from . import group_acc as GA
from .kernels import pad_steps
from .mxu_kernels import FUNC_CODES, MINMAX_SENTINEL, window_scan_min
from .staging import sidecar

# the jitter and masked rungs' functions on the tree (JAX JITTER_FUNCS)
JITTER_FUNCS = {
    "sum_over_time", "count_over_time", "avg_over_time", "last",
    "last_over_time", "first_over_time", "present_over_time",
    "absent_over_time", "stddev_over_time", "stdvar_over_time", "z_score",
    "rate", "increase", "delta", "idelta", "irate",
    "min_over_time", "max_over_time",
}

# selection rows of ``JitterWindowMatrices.idx``
F0, L0, L2, KLO, KHI = range(5)
# the kernel's step table: 24 words a step (csrc/jitter_range.cu StepRow)
STEP_WORDS = 24
STEP_BYTES = 4 * STEP_WORDS

# kernel launches since the last reset, per variant, and the last launch's
# layout (group_acc.TilePlan)
JITTER_LAUNCHES = 0
MASKED_LAUNCHES = 0
LAST_PLAN = None
# the lane mode's launches (both variants) and the last one's layout
LANE_LAUNCHES = 0
LAST_LANE_PLAN = None

_lib = None


def window_ok(window_ms: int, maxdev_ms: int) -> bool:
    """The rungs' one decline: a window not wider than the deviation band
    could hold one slot uncertain at both edges (``JitterWindowMatrices.ok``)."""
    return int(window_ms) > 2 * int(maxdev_ms)


class JitterWindowMatrices:
    """The certain/uncertain window structure of one (nominal grid, query
    grid, window), built on the host as the JAX package's
    ``JitterWindowMatrices`` (f32 casts included):

    - host numpy, named as in the JAX package: ``clo``/``chi`` (the certain
      range, clipped to [0, T]), ``count0``, ``c0pos``, ``c0ge2``,
      ``has_klo``, ``has_khi``, ``F0_rel``, ``L0_rel``, ``L2_rel``,
      ``Klo_rel``, ``Khi_rel`` (nominal times relative to each window's
      start), ``blo_rel``/``ehi_rel`` (the edge slots' membership bounds on
      the deviation) and ``idx`` int32 [5, J] (first, last, second-to-last
      certain slot, klo, khi; clipped);
    - ``steps`` on ``device``: all of that, and the nominal offsets at
      ``idx`` (from which a deviation is ``ts - nom``), as the kernel's
      int32 [J, STEP_WORDS] table, which the plain versions read too
      (``step_vectors``).

    ``ok`` is false, and nothing else is built, when the window is not
    wider than ``2 * maxdev``."""

    def __init__(self, nominal_ts: np.ndarray, n_valid: int, maxdev_ms: int, start_off: int,
                 step_ms: int, num_steps: int, window_ms: int, device):
        nominal_ts = np.asarray(nominal_ts)
        R = nominal_ts[:n_valid].astype(np.int64)
        T = len(nominal_ts)
        J = num_steps
        m = n_valid
        out_t = start_off + np.arange(J, dtype=np.int64) * step_ms
        b = out_t - window_ms
        e = out_t
        md = int(maxdev_ms)
        self.ok = window_ok(window_ms, md)
        self.window_ms = window_ms
        self.maxdev_ms = md
        if not self.ok:
            return
        clo = np.searchsorted(R, b + md, side="right")
        chi = np.searchsorted(R, e - md, side="right")
        count0 = np.maximum(chi - clo, 0)
        klo_a = np.searchsorted(R, b - md, side="right")
        klo_b = np.searchsorted(R, b + md, side="right")
        khi_a = np.searchsorted(R, e - md, side="right")
        khi_b = np.searchsorted(R, e + md, side="right")
        has_klo = (klo_b - klo_a) == 1
        has_khi = (khi_b - khi_a) == 1
        klo = np.where(has_klo, klo_a, 0)
        khi = np.where(has_khi, khi_a, 0)
        chi = np.minimum(chi, m)
        c0pos = count0 > 0
        c0ge2 = count0 >= 2
        self.idx = np.stack([
            np.clip(clo, 0, T - 1), np.clip(chi - 1, 0, T - 1), np.clip(chi - 2, 0, T - 1),
            np.clip(klo, 0, T - 1), np.clip(khi, 0, T - 1),
        ]).astype(np.int32)

        def rel(i, mask):
            r = R[np.clip(i, 0, m - 1)] - b
            return np.where(mask, r, 0).astype(np.float32)

        self.count0 = count0.astype(np.float32)
        self.c0pos, self.c0ge2, self.has_klo, self.has_khi = c0pos, c0ge2, has_klo, has_khi
        self.F0_rel = rel(clo, c0pos)
        self.L0_rel = rel(chi - 1, c0pos)
        self.L2_rel = rel(chi - 2, c0ge2)
        self.Klo_rel = rel(klo, has_klo)
        self.Khi_rel = rel(khi, has_khi)
        self.blo_rel = np.where(has_klo, b - R[np.clip(klo, 0, m - 1)],
                                2 * md + 1).astype(np.float32)
        self.ehi_rel = np.where(has_khi, e - R[np.clip(khi, 0, m - 1)],
                                -(2 * md) - 1).astype(np.float32)
        self.clo = np.clip(clo, 0, T).astype(np.int32)
        self.chi = np.clip(chi, 0, T).astype(np.int32)
        self.steps = self._table(nominal_ts, device)

    def _table(self, nominal_ts: np.ndarray, device) -> torch.Tensor:
        """The kernel's int32 [J, STEP_WORDS] step table on ``device``."""
        nom = np.asarray(nominal_ts).astype(np.int64)[self.idx]  # [5, J]
        flags = (self.c0pos * 1 | self.c0ge2 * 2 | self.has_klo * 4
                 | self.has_khi * 8).astype(np.int32)
        table = np.zeros((self.idx.shape[1], STEP_WORDS), np.int32)
        table[:, 0], table[:, 1] = self.clo, self.chi
        table[:, 2:7] = self.idx.T
        table[:, 7] = flags
        table[:, 8:16] = np.stack([getattr(self, name).astype(np.float32)
                                   for name in _STEP_F32], axis=1).view(np.int32)
        table[:, 16:21] = np.clip(nom.T, -2**31, 2**31 - 1).astype(np.int32)
        return torch.from_numpy(table).to(device)

    @classmethod
    def from_hist_args(cls, hwa, nominal_ts: np.ndarray, window_ms: int, maxdev_ms: int,
                       device) -> "JitterWindowMatrices":
        """The structure from the JAX package's histogram jitter arguments
        (``_hist_jwm_args`` order: clo, chi, idx, count0, c0pos, has_klo,
        has_khi, F0_rel, L0_rel, Klo_rel, Khi_rel, blo_rel, ehi_rel; any
        arrays ``np.asarray`` takes) over the block's ``nominal_ts``, so one
        structure feeds both packages. The histogram kernel reads no
        second-to-last slot: ``L2_rel`` is 0 there."""
        wm = cls.__new__(cls)
        (clo, chi, idx, count0, c0pos, has_klo, has_khi, F0_rel, L0_rel, Klo_rel, Khi_rel,
         blo_rel, ehi_rel) = (np.asarray(a) for a in hwa)
        wm.ok, wm.window_ms, wm.maxdev_ms = True, int(window_ms), int(maxdev_ms)
        wm.clo, wm.chi, wm.idx = clo.astype(np.int32), chi.astype(np.int32), idx.astype(np.int32)
        wm.count0 = count0.astype(np.float32)
        wm.c0pos, wm.has_klo, wm.has_khi = (c0pos.astype(bool), has_klo.astype(bool),
                                            has_khi.astype(bool))
        wm.c0ge2 = wm.count0 >= 2
        wm.F0_rel, wm.L0_rel, wm.Klo_rel, wm.Khi_rel, wm.blo_rel, wm.ehi_rel = (
            a.astype(np.float32) for a in (F0_rel, L0_rel, Klo_rel, Khi_rel, blo_rel, ehi_rel))
        wm.L2_rel = np.zeros_like(wm.F0_rel)
        wm.steps = wm._table(nominal_ts, device)
        return wm


# the f32 vectors of the step table's words 8..15, in order
_STEP_F32 = ("count0", "F0_rel", "L0_rel", "L2_rel", "Klo_rel", "Khi_rel", "blo_rel",
             "ehi_rel")


def step_vectors(wm: JitterWindowMatrices) -> dict:
    """The kernel's step table (``wm.steps``, csrc/jitter_range.cu StepRow)
    read back as the plain versions' [J] vectors on its device: ``clo``,
    ``chi``, ``idx`` and ``nom`` (int64 [5, J]), the flags ``c0pos``,
    ``c0ge2``, ``has_klo``, ``has_khi`` and the f32 ``_STEP_F32``."""
    t = wm.steps
    flags = t[:, 7]
    f = t[:, 8:16].contiguous().view(torch.float32)
    d = {name: f[:, i] for i, name in enumerate(_STEP_F32)}
    d.update(clo=t[:, 0].long(), chi=t[:, 1].long(), idx=t[:, 2:7].T.long(),
             nom=t[:, 16:21].T.long())
    for bit, name in enumerate(("c0pos", "c0ge2", "has_klo", "has_khi")):
        d[name] = (flags & (1 << bit)) != 0
    return d


def certain_sum(x: torch.Tensor, clo: torch.Tensor, chi: torch.Tensor) -> torch.Tensor:
    """[S, J] sum of ``x`` over each step's certain range [clo, chi), added
    in index order (the kernel's order, so the f32 rounding agrees)."""
    out = torch.zeros((x.shape[0], clo.shape[0]), dtype=x.dtype, device=x.device)
    if not clo.numel():
        return out
    lo, hi = int(clo.min()), int(chi.max())
    t = torch.arange(lo, max(hi, lo), device=x.device)[:, None]
    inside = (t >= clo) & (t < chi)  # [hi - lo, J]
    for i in range(hi - lo):
        out = out + torch.where(inside[i], x[:, lo + i : lo + i + 1], 0.0)
    return out


def _cached_window_matrices(block, memo: str, grid, start_off: int, step_ms: int,
                            num_steps: int, window_ms: int) -> JitterWindowMatrices:
    """One memo per block and query grid for both grid sources, built once
    under concurrency (``singleflight.memo_on``), on the block's device;
    ``grid()`` gives (nominal_ts, n_valid, maxdev_ms)."""
    key = (int(start_off), int(step_ms), int(num_steps), int(window_ms))
    return memo_on(block, memo, key, lambda: JitterWindowMatrices(
        *grid(), *key, device=block.vals.device))


def jitter_window_matrices(block, start_off: int, step_ms: int, num_steps: int,
                           window_ms: int) -> JitterWindowMatrices:
    """The window structure of a ``jitter`` block."""
    return _cached_window_matrices(
        block, "jitter_matrices_memo",
        lambda: (block.nominal_ts, int(block.lens[0]), block.maxdev_ms),
        start_off, step_ms, num_steps, window_ms)


def masked_window_matrices(block, start_off: int, step_ms: int, num_steps: int,
                           window_ms: int) -> JitterWindowMatrices:
    """The window structure of a ``holes`` block, over its sidecar's slots."""
    g = block.mgrid
    return _cached_window_matrices(block, "masked_matrices_memo",
                                   lambda: (g.nominal_ts, g.n_valid, g.maxdev_ms),
                                   start_off, step_ms, num_steps, window_ms)


def _w3(m1, a, m2, b, c):
    return torch.where(m1, a, torch.where(m2, b, c))


def _extrapolate(func, cnt, v_first, v_last, tf_rel, tl_rel, v_first_raw, window_ms,
                 is_counter):
    """rate/increase/delta from the window's first/last values and times
    relative to its start (the JAX kernels' shared tail)."""
    f32 = torch.float32
    w_ms = torch.tensor(np.float32(window_ms), dtype=f32, device=cnt.device)
    dlt = v_last - v_first
    sampled = (tl_rel - tf_rel) * 1e-3
    dur_start = tf_rel * 1e-3
    dur_end = (w_ms - tl_rel) * 1e-3
    avg_dur = sampled / torch.clamp(cnt - 1.0, min=1.0)
    thresh = avg_dur * 1.1
    inf = float("inf")
    if is_counter and func != "delta":
        dur_zero = torch.where(dlt > 0, sampled * (v_first_raw / torch.clamp(dlt, min=1e-30)),
                               inf)
        ds = torch.minimum(dur_start, torch.where(v_first_raw >= 0, dur_zero, inf))
    else:
        ds = dur_start
    ds = torch.where(ds >= thresh, avg_dur / 2.0, ds)
    de = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)
    res = dlt * ((sampled + ds + de) / torch.clamp(sampled, min=1e-30))
    if func == "rate":
        res = res / (w_ms * 1e-3)
    return torch.where(cnt >= 2, res, float("nan"))


def _sums(func, vals, d, in_lo, vKlo, in_hi, vKhi, cnt, v_last, window_ms):
    """The sum family and the moments: the certain window sum in index
    order (the kernel's) plus the members among klo, khi."""
    nan = float("nan")
    has = cnt > 0
    s = (certain_sum(vals, d["clo"], d["chi"]) + torch.where(in_lo, vKlo, 0.0)
         + torch.where(in_hi, vKhi, 0.0))
    if func == "avg_over_time":
        return torch.where(has, s / torch.clamp(cnt, min=1.0), nan)
    if func not in ("stddev_over_time", "stdvar_over_time", "z_score"):
        if func == "rate":
            s = s / (torch.tensor(np.float32(window_ms), device=s.device) * 1e-3)
        return torch.where(has, s, nan)
    s2 = (certain_sum(vals * vals, d["clo"], d["chi"]) + torch.where(in_lo, vKlo * vKlo, 0.0)
          + torch.where(in_hi, vKhi * vKhi, 0.0))
    c = torch.clamp(cnt, min=1.0)
    mean = s / c
    var = torch.clamp(s2 / c - mean * mean, min=0.0)
    if func == "stdvar_over_time":
        return torch.where(has, var, nan)
    sd = torch.sqrt(var)
    if func == "stddev_over_time":
        return torch.where(has, sd, nan)
    return torch.where(has, (v_last - mean) / torch.clamp(sd, min=1e-30), nan)


def _is_win_sum(func, is_delta) -> bool:
    return func == "sum_over_time" or (is_delta and func in ("rate", "increase"))


def jitter_range_plain(func: str, vals: torch.Tensor, ts: torch.Tensor, raw: torch.Tensor,
                       wm: JitterWindowMatrices, window_ms, is_counter: bool = False,
                       is_delta: bool = False) -> torch.Tensor:
    """[S, T] values of a ``jitter`` block -> [S, J], every branch of the
    JAX package's ``jitter_range_kernel`` (min/max: ``jitter_minmax_plain``)
    in its gather form; each deviation is ``ts - nominal`` at the selected
    slot."""
    if func in ("min_over_time", "max_over_time"):
        return jitter_minmax_plain(func, vals, ts, wm)
    d, nan = step_vectors(wm), float("nan")

    def sel(x, k):
        return x[:, d["idx"][k]]

    def dev(k):
        return (sel(ts, k).to(torch.int64) - d["nom"][k]).to(torch.float32)

    dKlo, dKhi = dev(KLO), dev(KHI)
    in_lo = d["has_klo"] & (dKlo > d["blo_rel"])
    in_hi = d["has_khi"] & (dKhi <= d["ehi_rel"])
    cnt = d["count0"] + in_lo + in_hi
    has = cnt > 0
    c0pos, c0ge2 = d["c0pos"].expand_as(cnt), d["c0ge2"].expand_as(cnt)
    if func == "count_over_time":
        return torch.where(has, cnt, nan)
    if func == "present_over_time":
        return torch.where(has, 1.0, nan)
    if func == "absent_over_time":
        return torch.where(has, nan, 1.0)
    vKlo, vKhi = sel(vals, KLO), sel(vals, KHI)

    def vlast(vL0):
        return _w3(in_hi, vKhi, c0pos, vL0, vKlo)

    def tlast(dL0):
        return _w3(in_hi, d["Khi_rel"] + dKhi, c0pos, d["L0_rel"] + dL0, d["Klo_rel"] + dKlo)

    if _is_win_sum(func, is_delta) or func in ("avg_over_time", "stddev_over_time",
                                                "stdvar_over_time", "z_score"):
        return _sums(func, vals, d, in_lo, vKlo, in_hi, vKhi, cnt,
                     vlast(sel(vals, L0)) if func == "z_score" else None, window_ms)
    if func == "first_over_time":
        return torch.where(has, _w3(in_lo, vKlo, c0pos, sel(vals, F0), vKhi), nan)
    if func in ("last", "last_over_time"):
        return torch.where(has, vlast(sel(vals, L0)), nan)
    if func in ("rate", "increase", "delta"):
        dF0, dL0 = dev(F0), dev(L0)
        v_first = _w3(in_lo, vKlo, c0pos, sel(vals, F0), vKhi)
        tf_rel = _w3(in_lo, d["Klo_rel"] + dKlo, c0pos, d["F0_rel"] + dF0, d["Khi_rel"] + dKhi)
        vfr = None
        if is_counter and func != "delta":
            vfr = _w3(in_lo, sel(raw, KLO), c0pos, sel(raw, F0), sel(raw, KHI))
        return _extrapolate(func, cnt, v_first, vlast(sel(vals, L0)), tf_rel, tlast(dL0), vfr,
                            window_ms, is_counter)
    if func in ("irate", "idelta"):
        ok2 = cnt >= 2
        v_last = vlast(sel(vals, L0))
        if func == "idelta" and is_counter and not is_delta:
            return torch.where(ok2, v_last, nan)  # diff-staged counters
        dL0, dL2 = dev(L0), dev(L2)
        vL0, vL2 = sel(vals, L0), sel(vals, L2)
        v_prev = torch.where(in_hi, torch.where(c0pos, vL0, vKlo), torch.where(c0ge2, vL2, vKlo))
        tp_rel = torch.where(
            in_hi, torch.where(c0pos, d["L0_rel"] + dL0, d["Klo_rel"] + dKlo),
            torch.where(c0ge2, d["L2_rel"] + dL2, d["Klo_rel"] + dKlo))
        dv = v_last - v_prev
        r = dv / torch.clamp((tlast(dL0) - tp_rel) * 1e-3, min=1e-30) if func == "irate" else dv
        return torch.where(ok2, r, nan)
    raise ValueError(f"jitter rung does not support {func}")


def jitter_minmax_plain(func: str, vals: torch.Tensor, ts: torch.Tensor,
                        wm: JitterWindowMatrices) -> torch.Tensor:
    """min/max_over_time on a ``jitter`` block (the JAX package's
    ``jitter_minmax``): the certain range scanned, then the members among
    klo, khi."""
    d = step_vectors(wm)
    is_min = func == "min_over_time"
    v = vals if is_min else -vals
    r = window_scan_min(v, d["clo"].tolist(), d["chi"].tolist())

    def dev(k):
        return (ts[:, d["idx"][k]].to(torch.int64) - d["nom"][k]).to(torch.float32)

    in_lo = d["has_klo"] & (dev(KLO) > d["blo_rel"])
    in_hi = d["has_khi"] & (dev(KHI) <= d["ehi_rel"])
    r = torch.minimum(r, torch.where(in_lo, v[:, d["idx"][KLO]], MINMAX_SENTINEL))
    r = torch.minimum(r, torch.where(in_hi, v[:, d["idx"][KHI]], MINMAX_SENTINEL))
    cnt = d["count0"] + in_lo + in_hi
    r = r if is_min else -r
    return torch.where(cnt > 0, r, float("nan"))


def masked_range_plain(func: str, g, wm: JitterWindowMatrices, window_ms,
                       is_counter: bool = False, is_delta: bool = False) -> torch.Tensor:
    """[S, T'] sidecar of a ``holes`` block -> [S, J], every branch of the
    JAX package's ``jitter_masked_kernel`` in its lean gather form (edge
    membership, validity and deviations from the time fills;
    min/max: ``masked_minmax_plain``)."""
    if func in ("min_over_time", "max_over_time"):
        return masked_minmax_plain(func, g, wm)
    d, nan = step_vectors(wm), float("nan")
    md = torch.tensor(np.float32(g.maxdev_ms), device=g.vals.device)

    def sel(x, k):
        return x[:, d["idx"][k]]

    dKlo, dKhi = sel(g.ffd, KLO), sel(g.bfd, KHI)
    in_lo = d["has_klo"] & (dKlo > d["blo_rel"])
    in_hi = d["has_khi"] & (dKhi <= d["ehi_rel"])
    vaF0 = torch.where(torch.abs(sel(g.ffd, F0)) <= md, 1.0, 0.0)
    cnt0v = torch.where(d["c0pos"], sel(g.cc, L0) - sel(g.cc, F0) + vaF0, 0.0)
    cnt = cnt0v + in_lo + in_hi
    has = cnt > 0
    c0pos, c0ge2 = cnt0v > 0, cnt0v >= 2
    if func == "count_over_time":
        return torch.where(has, cnt, nan)
    if func == "present_over_time":
        return torch.where(has, 1.0, nan)
    if func == "absent_over_time":
        return torch.where(has, nan, 1.0)
    ffvL0 = sel(g.ffv, L0)
    if func in ("rate", "increase", "delta") and not _is_win_sum(func, is_delta):
        # the backward fill at a valid klo/khi is the value there
        vKlo, vKhi = sel(g.bfv, KLO), sel(g.bfv, KHI)
        v_first = _w3(in_lo, vKlo, c0pos, sel(g.bfv, F0), vKhi)
        v_last = _w3(in_hi, vKhi, c0pos, ffvL0, vKlo)
        tf_rel = _w3(in_lo, d["Klo_rel"] + dKlo, c0pos, d["F0_rel"] + sel(g.bfd, F0),
                     d["Khi_rel"] + dKhi)
        tl_rel = _w3(in_hi, d["Khi_rel"] + dKhi, c0pos, d["L0_rel"] + sel(g.ffd, L0),
                     d["Klo_rel"] + dKlo)
        vfr = None
        if is_counter and func != "delta":
            bfraw = g.bfraw if g.bfraw is not None else g.bfv
            vfr = _w3(in_lo, sel(bfraw, KLO), c0pos, sel(bfraw, F0), sel(bfraw, KHI))
        return _extrapolate(func, cnt, v_first, v_last, tf_rel, tl_rel, vfr, window_ms,
                            is_counter)
    vKlo, vKhi = sel(g.vals, KLO), sel(g.vals, KHI)

    def vlast(vL0):
        return _w3(in_hi, vKhi, c0pos, vL0, vKlo)

    if _is_win_sum(func, is_delta) or func in ("avg_over_time", "stddev_over_time",
                                                "stdvar_over_time", "z_score"):
        return _sums(func, g.vals, d, in_lo, vKlo, in_hi, vKhi, cnt,
                     vlast(ffvL0) if func == "z_score" else None, window_ms)
    if func == "first_over_time":
        return torch.where(has, _w3(in_lo, vKlo, c0pos, sel(g.bfv, F0), vKhi), nan)
    if func in ("last", "last_over_time"):
        return torch.where(has, vlast(ffvL0), nan)
    if func in ("irate", "idelta"):
        ok2 = cnt >= 2
        v_last = vlast(ffvL0)
        if func == "idelta" and is_counter and not is_delta:
            return torch.where(ok2, v_last, nan)  # diff-staged counters
        ffdL0 = sel(g.ffd, L0)
        tl_rel = _w3(in_hi, d["Khi_rel"] + dKhi, c0pos, d["L0_rel"] + ffdL0,
                     d["Klo_rel"] + dKlo)
        v_prev = torch.where(in_hi, torch.where(c0pos, ffvL0, vKlo),
                             torch.where(c0ge2, sel(g.ff2v, L0), vKlo))
        tp_rel = torch.where(
            in_hi, torch.where(c0pos, d["L0_rel"] + ffdL0, d["Klo_rel"] + dKlo),
            torch.where(c0ge2, d["L0_rel"] + sel(g.ff2d, L0), d["Klo_rel"] + dKlo))
        dv = v_last - v_prev
        r = dv / torch.clamp((tl_rel - tp_rel) * 1e-3, min=1e-30) if func == "irate" else dv
        return torch.where(ok2, r, nan)
    raise ValueError(f"masked rung does not support {func}")


def masked_minmax_plain(func: str, g, wm: JitterWindowMatrices) -> torch.Tensor:
    """min/max_over_time over a ``holes`` block's sidecar (the JAX
    package's ``jitter_masked_minmax``): holes never count, a slot being
    valid where its forward time fill lies within maxdev."""
    d = step_vectors(wm)
    md = torch.tensor(np.float32(g.maxdev_ms), device=g.vals.device)
    valid = torch.abs(g.ffd) <= md
    is_min = func == "min_over_time"
    v = g.vals if is_min else -g.vals
    r = window_scan_min(torch.where(valid, v, MINMAX_SENTINEL), d["clo"].tolist(),
                        d["chi"].tolist())

    def sel(x, k):
        return x[:, d["idx"][k]]

    in_lo = d["has_klo"] & (sel(g.ffd, KLO) > d["blo_rel"]) & sel(valid, KLO)
    in_hi = d["has_khi"] & (sel(g.ffd, KHI) <= d["ehi_rel"]) & sel(valid, KHI)
    r = torch.minimum(r, torch.where(in_lo, sel(v, KLO), MINMAX_SENTINEL))
    r = torch.minimum(r, torch.where(in_hi, sel(v, KHI), MINMAX_SENTINEL))
    vaF0 = torch.where(sel(valid, F0), 1.0, 0.0)
    cnt0v = torch.where(d["c0pos"], sel(g.cc, L0) - sel(g.cc, F0) + vaF0, 0.0)
    cnt = cnt0v + in_lo + in_hi
    r = r if is_min else -r
    return torch.where(cnt > 0, r, float("nan"))


# -- the kernel ---------------------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point's argument types on a built library."""
    fn = lib.filodb_jitter_range
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    fn = lib.filodb_jitter_range_lanes
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("jitter_range"))))
    return _lib


def _check(gids, **planes) -> None:
    """Every plane [S, T] f32 (``ts`` int32) on one device, contiguous and
    16-byte aligned; ``gids`` int64 [S]."""
    first = next(iter(planes.values()))
    S, T = first.shape
    for name, t in planes.items():
        dtype = torch.int32 if name == "ts" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (S, T):
            raise ValueError(f"{name} must have shape {(S, T)}, got {tuple(t.shape)}")
        if t.device != first.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {first.device}")
    if gids.dtype != torch.int64 or tuple(gids.shape) != (S,) or gids.device != first.device:
        raise ValueError(f"gids must be int64 [{S}] on {first.device}")
    GA.check_aligned(**planes)


def _planes(masked: bool, block) -> dict:
    if masked:
        g = block.mgrid
        return {"vals": g.vals, "cc": g.cc, "ffv": g.ffv, "ffd": g.ffd, "bfv": g.bfv,
                "bfd": g.bfd, "ff2v": g.ff2v, "ff2d": g.ff2d,
                "bfraw": g.bfraw if g.bfraw is not None else g.bfv}
    return {"vals": block.vals, "ts": block.ts,
            "raw": block.raw if block.raw is not None else block.vals}


def _launch(masked: bool, func: str, op: str, planes: dict, gids, num_groups: int,
            wm: JitterWindowMatrices, num_steps: int, is_counter: bool, is_delta: bool,
            maxdev_ms: int, acc: torch.Tensor, cnt: torch.Tensor, plan=None,
            lib=None) -> None:
    """One launch of the jitter kernel (``masked``: its MASKED variant) over
    the first ``num_steps`` steps into ``acc``/``cnt`` ([G+1, J_pad]), or
    with ``op`` ``group_acc.STORE`` into the grid ``acc`` ([J_pad, S]);
    raises if the launch fails. The step table goes to shared memory
    after the partials while both fit a block's."""
    global JITTER_LAUNCHES, MASKED_LAUNCHES, LAST_PLAN
    lib = lib or _load()
    vals = planes["vals"]
    S, T = vals.shape
    if plan is None:
        plan = GA.tile_plan(num_groups, num_steps, 0, 0, store=op == GA.STORE)
    stage = plan.smem_bytes + num_steps * STEP_BYTES <= GA.BLOCK_SMEM
    smem = plan.smem_bytes + (num_steps * STEP_BYTES if stage else 0)

    def ptr(name):
        t = planes.get(name)
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.filodb_jitter_range(
            int(masked), vals.data_ptr(), ptr("ts"), ptr("raw"), ptr("cc"), ptr("ffv"),
            ptr("ffd"), ptr("bfv"), ptr("bfd"), ptr("ff2v"), ptr("ff2d"), ptr("bfraw"),
            gids.data_ptr(), wm.steps.data_ptr(), S, T, num_steps, wm.steps.shape[0],
            num_groups, float(np.float32(wm.window_ms)), float(np.float32(maxdev_ms)),
            FUNC_CODES[func], GA.acc_code(op), int(is_counter), int(is_delta), plan.rows,
            int(plan.shared), int(stage), smem, acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"jitter_range kernel launch failed: cudaError {err}")
    if masked:
        MASKED_LAUNCHES += 1
    else:
        JITTER_LAUNCHES += 1
    LAST_PLAN = plan


def _prepare(masked: bool, func: str, block, params, gids):
    if func not in JITTER_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the jitter rung")
    if masked and sidecar(block) is None:
        raise ValueError("the masked rung needs a block with a masked sidecar (holes)")
    if not masked and block.nominal_ts is None:
        raise ValueError("the jitter rung needs a block with a nominal grid (jitter)")
    start_off = int(params.start_ms - block.base_ms)
    j_pad = pad_steps(params.num_steps)
    wm = (masked_window_matrices if masked else jitter_window_matrices)(
        block, start_off, params.step_ms, j_pad, params.window_ms)
    if not wm.ok:
        raise ValueError(f"window {params.window_ms} ms is not wider than twice the grid's "
                         f"deviation bound: the ladder takes another rung")
    planes = _planes(masked, block)
    _check(gids, **planes)
    return wm, planes


def _plain(masked: bool, func: str, block, wm, params, is_counter, is_delta):
    if masked:
        return masked_range_plain(func, block.mgrid, wm, params.window_ms, is_counter, is_delta)
    raw = block.raw if block.raw is not None else block.vals
    return jitter_range_plain(func, block.vals, block.ts, raw, wm, params.window_ms,
                              is_counter, is_delta)


def _maxdev(masked: bool, block) -> int:
    return block.mgrid.maxdev_ms if masked else block.maxdev_ms


def _aggregate(masked: bool, func: str, op: str, block, gids, num_groups: int, params,
               is_counter: bool, is_delta: bool) -> torch.Tensor:
    from .aggregations import SIMPLE_AGG_OPS, apply_epilogue

    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    wm, planes = _prepare(masked, func, block, params, gids)
    device = planes["vals"].device.type
    if device == "cpu":
        sj = _plain(masked, func, block, wm, params, is_counter, is_delta)
        return GA.mask_steps(apply_epilogue(sj, ("agg", op), gids, num_groups),
                             params.num_steps)
    if device != "cuda":
        raise ValueError(f"the jitter rung runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.accumulators(op, num_groups, wm.steps.shape[0], planes["vals"].device)
    _launch(masked, func, op, planes, gids, num_groups, wm, params.num_steps, is_counter,
            is_delta, _maxdev(masked, block), acc, cnt)
    return GA.finish_groups(op, acc, cnt, num_groups)


def _series(masked: bool, func: str, block, gids, num_groups: int, params, is_counter: bool,
            is_delta: bool) -> torch.Tensor:
    wm, planes = _prepare(masked, func, block, params, gids)
    vals = planes["vals"]
    return GA.run_series(
        vals.device, vals.shape[0], gids, num_groups, params.num_steps,
        lambda: _plain(masked, func, block, wm, params, is_counter, is_delta),
        lambda out: _launch(masked, func, GA.STORE, planes, gids, num_groups, wm,
                            params.num_steps, is_counter, is_delta, _maxdev(masked, block),
                            out, out))


def jitter_range_aggregate(func: str, op: str, block, gids: torch.Tensor, num_groups: int,
                           params, is_counter: bool = False,
                           is_delta: bool = False) -> torch.Tensor:
    """``op by (...) (func(selector[w]))`` over a ``jitter`` block ->
    [G, J_pad] group values on the block's device (NaN past
    ``params.num_steps``): one launch of the JITTER variant on a CUDA
    block, ``jitter_range_plain`` and the segment aggregate on a CPU
    block. Raises for a window the rung declines (``window_ok``)."""
    return _aggregate(False, func, op, block, gids, num_groups, params, is_counter, is_delta)


def jitter_range_series(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        is_counter: bool = False, is_delta: bool = False) -> torch.Tensor:
    """``func(selector[w])`` of every series of a ``jitter`` block -> the
    step-major [J_pad, S_pad] grid (the store mode: the fused epilogues and
    the tree), trash rows and steps past ``params.num_steps`` NaN."""
    return _series(False, func, block, gids, num_groups, params, is_counter, is_delta)


def masked_range_aggregate(func: str, op: str, block, gids: torch.Tensor, num_groups: int,
                           params, is_counter: bool = False,
                           is_delta: bool = False) -> torch.Tensor:
    """``jitter_range_aggregate`` over a ``holes`` block's sidecar (the
    MASKED variant; ``masked_range_plain`` on the CPU)."""
    return _aggregate(True, func, op, block, gids, num_groups, params, is_counter, is_delta)


def masked_range_series(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        is_counter: bool = False, is_delta: bool = False) -> torch.Tensor:
    """``jitter_range_series`` over a ``holes`` block's sidecar."""
    return _series(True, func, block, gids, num_groups, params, is_counter, is_delta)



# -- lane mode (cross-query batching, B12) -------------------------------------


def lane_windows(masked: bool, block, ukeys, j_pad: int) -> dict:
    """The stacked window structure of a lane-mode launch: each unique
    window ``(start_off, step, window)`` of ``ukeys`` its window structure
    (``wms``, the solo launches' memo), their step tables stacked [U, j_pad,
    STEP_WORDS] and window_ms [U] f32. Raises where a window's structure
    declines it (``ok`` false): ``aggregations.lanes_variant`` keeps such
    groups solo."""
    build = masked_window_matrices if masked else jitter_window_matrices
    wms = [build(block, so, sm, j_pad, w) for so, sm, w in ukeys]
    if not all(w.ok for w in wms):
        raise ValueError("a window of the batch is not wider than twice the grid's deviation "
                         "bound")
    return {"wms": wms, "steps": torch.stack([w.steps for w in wms]).contiguous(),
            "window_ms": torch.tensor([float(np.float32(w)) for *_, w in ukeys],
                                      dtype=torch.float32, device=block.vals.device)}


def _launch_lanes(masked: bool, func: str, op: str, planes: dict, batch, is_counter: bool,
                  is_delta: bool, maxdev_ms: int, acc: torch.Tensor, cnt: torch.Tensor,
                  plan=None, lib=None) -> None:
    """One launch of the jitter kernel's lane mode (``masked``: its MASKED
    variant) over ``batch`` (an ``aggregations.LaneBatch``) into the lanes'
    ``acc``/``cnt`` ([L, G+1, J_pad]), or with ``op`` ``group_acc.STORE``
    into the [U, J_pad, S] grids ``acc``; raises if the launch fails."""
    global LANE_LAUNCHES, LAST_LANE_PLAN
    lib = lib or _load()
    vals = planes["vals"]
    S, T = vals.shape
    store = op == GA.STORE
    gids = batch.store_gids if store else batch.gids
    L, G = (1, 1) if store else (gids.shape[0], batch.G)
    lanes_max = 1 if store else batch.lanes_max
    if plan is None:
        plan = GA.tile_plan(G, batch.num_steps, 0, 0, store=store, lanes=lanes_max)
    w = batch.windows

    def ptr(name):
        t = planes.get(name)
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.filodb_jitter_range_lanes(
            int(masked), vals.data_ptr(), ptr("ts"), ptr("raw"), ptr("cc"), ptr("ffv"),
            ptr("ffd"), ptr("bfv"), ptr("bfd"), ptr("ff2v"), ptr("ff2d"), ptr("bfraw"),
            w["steps"].data_ptr(), w["window_ms"].data_ptr(), S, T, batch.num_steps,
            batch.j_pad, len(batch.ukeys), float(np.float32(maxdev_ms)), gids.data_ptr(),
            batch.u_dev.data_ptr(), L, G, FUNC_CODES[func], GA.acc_code(op), int(is_counter),
            int(is_delta), plan.rows, int(plan.shared), lanes_max, plan.smem_bytes,
            acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"jitter_range lane-mode launch failed: cudaError {err}")
    LANE_LAUNCHES += 1
    LAST_LANE_PLAN = plan


def _lane_prepare(masked: bool, func: str, block) -> dict:
    if func not in JITTER_FUNCS or func in ("min_over_time", "max_over_time"):
        raise NotImplementedError(f"range function {func!r} has no lane mode on the jitter rung")
    if masked and sidecar(block) is None:
        raise ValueError("the masked rung needs a block with a masked sidecar (holes)")
    if not masked and block.nominal_ts is None:
        raise ValueError("the jitter rung needs a block with a nominal grid (jitter)")
    planes = _planes(masked, block)
    GA.check_aligned(**planes)
    return planes


def _lane_series_plain(masked: bool, func: str, block, batch, u: int, is_counter: bool,
                       is_delta: bool):
    wm, window = batch.windows["wms"][u], batch.ukeys[u][2]
    if masked:
        return masked_range_plain(func, block.mgrid, wm, window, is_counter, is_delta)
    raw = block.raw if block.raw is not None else block.vals
    return jitter_range_plain(func, block.vals, block.ts, raw, wm, window, is_counter, is_delta)


def _lanes_plain(masked: bool, func: str, op: str, block, lanes, batch, is_counter: bool = False,
                 is_delta: bool = False) -> list:
    """The lane mode in plain torch: the variant's plain version once per
    unique window, each lane's segment aggregate (``group_acc.lanes_plain``)."""
    return GA.lanes_plain(
        lambda u: _lane_series_plain(masked, func, block, batch, u, is_counter, is_delta), op,
        lanes, batch.u_of_lane)


def _lanes_series_plain(masked: bool, func: str, block, batch, is_counter: bool = False,
                        is_delta: bool = False) -> torch.Tensor:
    """The lane store mode in plain torch: each unique window's plain
    version through ``group_acc.series_grid``."""
    return torch.stack([
        GA.series_grid(_lane_series_plain(masked, func, block, batch, u, is_counter, is_delta),
                       batch.store_gids[0], 1, batch.num_steps) for u in range(len(batch.ukeys))])


def _lanes(masked: bool, func: str, op: str, block, lanes, batch, is_counter: bool,
           is_delta: bool) -> list:
    from .aggregations import SIMPLE_AGG_OPS

    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    planes = _lane_prepare(masked, func, block)
    device = planes["vals"].device
    if device.type == "cpu":
        return _lanes_plain(masked, func, op, block, lanes, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"the jitter rung runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.lane_accumulators(op, len(lanes), batch.G, batch.j_pad, device)
    _launch_lanes(masked, func, op, planes, batch, is_counter, is_delta, _maxdev(masked, block),
                  acc, cnt)
    return GA.finish_lanes(op, acc, cnt, lanes)


def _lanes_series(masked: bool, func: str, block, batch, is_counter: bool,
                  is_delta: bool) -> torch.Tensor:
    planes = _lane_prepare(masked, func, block)
    vals = planes["vals"]
    U, S = len(batch.ukeys), vals.shape[0]
    if vals.device.type == "cpu":
        return _lanes_series_plain(masked, func, block, batch, is_counter, is_delta)
    if vals.device.type != "cuda":
        raise ValueError(f"the jitter rung runs on cuda or cpu tensors, not {vals.device}")
    out = GA.lane_series_buffer(U, S, batch.j_pad, batch.num_steps, vals.device)
    _launch_lanes(masked, func, GA.STORE, planes, batch, is_counter, is_delta,
                  _maxdev(masked, block), out, out)
    return out


def jitter_range_lanes_plain(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                             is_delta: bool = False) -> list:
    """The JITTER variant's lane mode in plain torch (``_lanes_plain``)."""
    return _lanes_plain(False, func, op, block, lanes, batch, is_counter, is_delta)


def jitter_range_lanes_series_plain(func: str, block, batch, is_counter: bool = False,
                                    is_delta: bool = False) -> torch.Tensor:
    """The JITTER variant's lane store mode in plain torch."""
    return _lanes_series_plain(False, func, block, batch, is_counter, is_delta)


def masked_range_lanes_plain(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                             is_delta: bool = False) -> list:
    """The MASKED variant's lane mode in plain torch (``_lanes_plain``)."""
    return _lanes_plain(True, func, op, block, lanes, batch, is_counter, is_delta)


def masked_range_lanes_series_plain(func: str, block, batch, is_counter: bool = False,
                                    is_delta: bool = False) -> torch.Tensor:
    """The MASKED variant's lane store mode in plain torch."""
    return _lanes_series_plain(True, func, block, batch, is_counter, is_delta)


def jitter_range_lanes(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                       is_delta: bool = False) -> list:
    """``op by (...) (func(selector[w]))`` of every lane of ``batch`` (an
    ``aggregations.LaneBatch``) over a ``jitter`` block -> each lane's
    [G_l, J_pad] values, NaN past its own ``num_steps``: ONE launch of the
    JITTER variant's lane mode on a CUDA block, ``jitter_range_lanes_plain``
    on a CPU block."""
    return _lanes(False, func, op, block, lanes, batch, is_counter, is_delta)


def jitter_range_lanes_series(func: str, block, batch, is_counter: bool = False,
                              is_delta: bool = False) -> torch.Tensor:
    """Every unique window's store grid of a ``jitter`` block -> [U, J_pad,
    S_pad] (ONE launch of the lane store mode)."""
    return _lanes_series(False, func, block, batch, is_counter, is_delta)


def masked_range_lanes(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                       is_delta: bool = False) -> list:
    """``jitter_range_lanes`` over a ``holes`` block's sidecar (the MASKED
    variant)."""
    return _lanes(True, func, op, block, lanes, batch, is_counter, is_delta)


def masked_range_lanes_series(func: str, block, batch, is_counter: bool = False,
                              is_delta: bool = False) -> torch.Tensor:
    """``jitter_range_lanes_series`` over a ``holes`` block's sidecar."""
    return _lanes_series(True, func, block, batch, is_counter, is_delta)
