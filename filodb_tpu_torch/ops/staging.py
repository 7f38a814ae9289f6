"""Staging: memstore chunk windows -> fixed-shape blocks on the device
(counterpart of ``filodb_tpu/ops/staging.py``).

All samples of all selected series in [start - window, end] gather into one
padded ``[series, time]`` block, which moves to the device once:

- NaN samples (staleness markers) are dropped on the host, so validity on
  the device is purely "index < length".
- Timestamps become int32 ms offsets from ``base_ms``; padded slots hold
  ``TS_PAD``, which sorts after every real timestamp.
- Counters are reset-corrected on the host in f64 and staged minus a
  per-series baseline, so f32 keeps full precision on large raw counters
  and the device needs no correction pass. Raw values ride along for
  Prometheus' zero-crossing extrapolation cap.
- S and T pad up to bucketed sizes.
- Native histograms stage raw cumulative bucket counts as ``[S, T, B]``
  (``stage_histogram_series``), one bucket scheme per block.
- Every block is classified by its time grid (``grid_class``): ``regular``
  when every real series shares one exact timestamp vector (the regular
  range kernel), ``jitter`` when the series are near-regular (the jitter
  kernel, which derives each sample's deviation from ``ts`` and
  ``nominal_ts`` on the device), ``holes`` when they are near-regular with
  missed scrapes (a slot-aligned ``MaskedGrid`` sidecar, the masked
  kernel; a shard's or a superblock's is built by its device copy, on
  the device, and stays there), else ``irregular`` (the window-stats and
  general kernels).
  ``stage_from_shard`` repairs ragged jittered edges (``_slot_align``), so
  such a selection stays ``jitter``.

Live ingest does not restage a cached block: ``append_to_block`` (a
shard's host-staged block) and ``extend_superblock`` (the cross-shard
superblock on the device) append the samples that arrived past its head,
from host mirrors that ``to_device(keep_host=True)`` keeps, and
``SuperblockCache`` holds superblocks keyed by their member shards' version
vector. A ``holes`` block is restaged, not extended, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.histograms import same_scheme
from ..singleflight import KeyedSingleFlight

_S_BUCKETS = (8, 32, 128, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)


def pad_series(s: int) -> int:
    for b in _S_BUCKETS:
        if s <= b:
            return b
    return ((s + 8191) // 8192) * 8192


def pad_time(t: int) -> int:
    return max(128, ((t + 127) // 128) * 128)


TS_PAD = np.int32(2**31 - 1)  # padded slots sort after every real timestamp

# Widest selector span a staged block represents exactly (int32 ms offsets).
MAX_STAGE_SPAN_MS = 2**31 - 2

# masked (missed-scrape) grids tolerate at most this share of holes
MAX_HOLE_FRAC = 0.05

# the sidecar's planes, all the masked kernel reads (csrc/jitter_range.cu,
# MASKED). Validity, deviations and raw values at the valid slots are read
# from them (``MaskedGrid.valid``/``dev``/``raw``), so no other is kept.
MASKED_PLANES = ("vals", "cc", "ffv", "ffd", "bfv", "bfd", "ff2v", "ff2d", "bfraw")


@dataclass
class MaskedGrid:
    """Slot-aligned sidecar of near-regular data with missed scrapes (the
    JAX package's ``MaskedGrid``). The packed block stays canonical; the
    sidecar maps each sample to its nominal slot and carries per-slot
    values, running count and forward/backward fills, so the masked kernel
    evaluates first/last/rate at shared slot indices. All [S, T'] f32
    tensors on the device that built them, holes 0 (T' counts slots and
    may exceed the block's T):

    - vals: the value at each valid slot
    - ffv/ffd: value / time offset of the last valid slot <= t
      (ffd = R[t'] - R[t] + dev[s, t'])
    - bfv/bfd: value / time offset of the first valid slot >= t
    - ff2v/ff2d: value / time offset of the second-to-last valid slot <= t
    - bfraw: backward fill of raw values (the counter extrapolation cap)
    - cc: the running count of valid slots

    The JAX package's ``valid``, ``dev`` and ``raw`` planes are derived
    (``masked_fills``' invariant: at a valid slot ffd is its deviation and
    bfraw its raw value)."""

    nominal_ts: np.ndarray  # [T'] int32 ms offsets of the slot grid
    n_valid: int  # real slot count (grid width; <= T')
    interval_ms: float  # refined nominal interval
    maxdev_ms: int
    vals: torch.Tensor
    ffv: torch.Tensor
    ffd: torch.Tensor
    bfv: torch.Tensor
    bfd: torch.Tensor
    ff2v: torch.Tensor
    ff2d: torch.Tensor
    bfraw: torch.Tensor | None
    cc: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        """1 at a slot that holds a sample, else 0 (from the running count)."""
        return torch.diff(self.cc, dim=1, prepend=torch.zeros_like(self.cc[:, :1]))

    @property
    def dev(self) -> torch.Tensor:
        """Each valid slot's deviation from its nominal time (ms), holes 0."""
        return torch.where(self.valid > 0, self.ffd, 0.0)

    @property
    def raw(self) -> torch.Tensor | None:
        """Each valid slot's raw value (counters only), holes 0."""
        return None if self.bfraw is None else torch.where(self.valid > 0, self.bfraw, 0.0)

    def device_copy(self, device) -> "MaskedGrid":
        """This grid with its planes on ``device`` (the same tensors where
        they already lie there); this grid is left as it is."""
        planes = {f: None if getattr(self, f) is None else getattr(self, f).to(device)
                  for f in MASKED_PLANES}
        return MaskedGrid(self.nominal_ts, self.n_valid, self.interval_ms, self.maxdev_ms,
                          **planes)

    def nbytes(self) -> int:
        return sum(int(getattr(self, f).nbytes) for f in MASKED_PLANES
                   if getattr(self, f) is not None)


def _flatten(cleaned):
    """Series as (every sample's int64 ts concatenated, per-series counts);
    ``cleaned`` is a list of (ts, values) or already that pair."""
    if isinstance(cleaned, tuple):
        return cleaned
    lens = np.fromiter((len(ts) for ts, _ in cleaned), np.int64, len(cleaned))
    flat = (np.concatenate([ts for ts, _ in cleaned]).astype(np.int64) if len(cleaned)
            else np.zeros(0, np.int64))
    return flat, lens


def _slot_indices(ts, lens, t0: float, interval: float):
    """Every sample's nominal slot index rint((ts - t0) / interval) in one
    pass over the concatenated samples ``ts`` of series of ``lens``
    samples, and whether any series puts two samples in one slot."""
    k = np.rint((ts.astype(np.float64) - t0) / interval).astype(np.int64)
    inner = np.ones(max(len(k) - 1, 0), bool)
    ends = np.cumsum(lens)[:-1]
    inner[ends[(ends > 0) & (ends < len(k))] - 1] = False  # pairs across two series
    return k, bool((np.diff(k)[inner] < 1).any())


def _snap_flat(cleaned):
    """``_snap_slots`` over concatenated series (``_flatten``): (interval_ms,
    t0_ms, slots, ts, counts) or None."""
    ts, lens = _flatten(cleaned)
    if not len(lens) or (lens < 2).any():
        return None
    ends = np.cumsum(lens)
    longest = int(np.argmax(lens))  # the first of the longest, as max(key=len)
    ref = ts[ends[longest] - lens[longest]: ends[longest]]
    d = np.diff(ref)
    if not len(d) or (d <= 0).any():
        return None
    est = float(np.median(d))
    if est <= 0:
        return None
    k = np.rint(d / est)
    if (k < 1).any():
        return None
    # least-squares interval over the reference series
    interval = float(d.sum()) / float(k.sum())
    if interval <= 0:
        return None
    t0 = float(ref[0])
    slots, clash = _slot_indices(ts, lens, t0, interval)
    if clash:
        return None  # two samples snapped to one slot: not this grid
    return interval, t0, slots, ts, lens


def _snap_slots(cleaned) -> tuple[float, float, list] | None:
    """A shared nominal grid of series with missed scrapes: (interval_ms,
    t0_ms, [per-series slot indices]), or None when the data is not
    near-regular with holes (the JAX package's rule)."""
    snap = _snap_flat(cleaned)
    if snap is None:
        return None
    interval, t0, slots, _, lens = snap
    return interval, t0, np.split(slots, np.cumsum(lens)[:-1])


def masked_fills(valid, m_vals, m_dev, m_raw, R, device=None):
    """Forward/backward fills over slot-aligned masked arrays (the
    ``MaskedGrid`` fill semantics); ``R`` is the int64 nominal offset
    vector. Returns (ffv, ffd, bfv, bfd, ff2v, ff2d, bfraw), f32 tensors on
    ``device`` (default the host's threads).

    A slot with no valid neighbour in the fill's direction carries value 0
    and a signed time sentinel (-3e38 forward, +3e38 backward): at a valid
    slot ffd == bfd == dev (|.| <= maxdev), at a hole ffd <= -(interval -
    maxdev) and bfd >= interval - maxdev, so window membership and slot
    validity are decided from the time fills alone. Computed in the JAX
    package's operations (gathers, f64 offsets, one rounding to f32), so the
    planes equal its numpy ones."""
    T = valid.shape[1]

    def put(a):
        return torch.as_tensor(a).to(device or "cpu")

    V = put(valid) > 0
    tind = torch.arange(T, device=V.device)
    ffi = torch.cummax(torch.where(V, tind, -1), dim=1).values
    rev = torch.cummax(torch.where(V.flip(1), tind, -1), dim=1).values.flip(1)
    bfi = torch.where(rev >= 0, T - 1 - rev, T)
    del rev
    ff2i = torch.where(ffi >= 1, torch.gather(ffi, 1, (ffi - 1).clamp(0, T - 1)), -1)
    Rf = put(np.asarray(R, np.float64))
    dev, vals = put(m_dev), put(m_vals)

    def fill(src, idx, t_sentinel, times=True):
        ok = (idx >= 0) & (idx < T)
        ic = idx.clamp(0, T - 1)
        v = torch.where(ok, torch.gather(src, 1, ic), 0.0)
        if not times:
            return v, None
        dd = (Rf[ic] - Rf[None, :]) + torch.gather(dev, 1, ic).double()
        return v, torch.where(ok, dd, t_sentinel).float()

    ffv, ffd = fill(vals, ffi, -3e38)
    bfv, bfd = fill(vals, bfi, 3e38)
    ff2v, ff2d = fill(vals, ff2i, -3e38)
    bfraw = fill(put(m_raw), bfi, 3e38, times=False)[0] if m_raw is not None else None
    return ffv, ffd, bfv, bfd, ff2v, ff2d, bfraw


def _build_masked_grid(cleaned, base_ms, out_vals, out_raw, lens, T: int, S: int,
                       grid=None, device=None) -> MaskedGrid | None:
    """Slot-align packed values onto a shared nominal grid with validity
    holes; None when the deviation bound or the hole share fails.
    ``cleaned`` lists the series' (ts, values), or is ``_flatten``'s pair.
    ``grid`` forces an (interval_ms, t0_abs_ms) pair (``harmonize_masked``:
    every block on one common grid, slot 0 at t0). The planes are built on
    ``device`` (default the host's threads) and stay there."""
    if grid is None:
        snap = _snap_flat(cleaned)
        if snap is None:
            return None
        interval, t0, k, ts, counts = snap
        starts = np.cumsum(counts) - counts
        kmin = int(k[starts].min())
    else:
        interval, t0 = grid
        ts, counts = _flatten(cleaned)
        k, clash = _slot_indices(ts, counts, t0, interval)
        if clash or (k < 0).any():
            return None
        kmin = 0
    kmax = int(k[np.cumsum(counts) - 1].max())
    width = kmax - kmin + 1
    # the sidecar is as wide as the slot span, which holes stretch past the
    # packed width
    T = max(T, pad_time(width))
    n = len(counts)
    if grid is None and int(counts.sum()) < n * width * (1.0 - MAX_HOLE_FRAC):
        return None
    nom_abs = np.rint(t0 + (kmin + np.arange(T, dtype=np.float64)) * interval).astype(np.int64)
    # every sample at once (row i's are out_vals[i, :lens[i]], in order),
    # scattered on ``device`` into flat [S * T] planes
    slots = k - kmin
    dv = ts - nom_abs[slots]
    md = int(np.abs(dv).max())
    if 2 * md >= interval:
        return None  # the jitter rung's bound
    packed = np.arange(out_vals.shape[1])[None, :] < np.asarray(lens)[:n, None]
    at = torch.from_numpy(np.repeat(np.arange(n), counts) * T + slots).to(device or "cpu")

    def plane(values=None):
        p = torch.zeros(S * T, dtype=torch.float32, device=at.device)
        p[at] = 1.0 if values is None else torch.from_numpy(
            np.ascontiguousarray(values, np.float32)).to(at.device)
        return p.view(S, T)

    valid = plane()
    m_vals = plane(out_vals[:n][packed])
    m_dev = plane(dv.astype(np.float32))
    m_raw = plane(out_raw[:n][packed]) if out_raw is not None else None
    R = (nom_abs - base_ms).astype(np.int64)
    if R.max() > 2**31 - 2 or R.min() < -(2**31):
        return None
    ffv, ffd, bfv, bfd, ff2v, ff2d, bfraw = masked_fills(valid, m_vals, m_dev, m_raw, R,
                                                         device)
    del m_dev, m_raw
    nominal = np.full(T, TS_PAD, dtype=np.int32)
    nominal[:width] = R[:width].astype(np.int32)
    return MaskedGrid(
        nominal_ts=nominal, n_valid=width, interval_ms=float(interval), maxdev_ms=md,
        vals=m_vals, ffv=ffv, ffd=ffd, bfv=bfv, bfd=bfd, ff2v=ff2v, ff2d=ff2d, bfraw=bfraw,
        cc=torch.cumsum(valid, 1, dtype=torch.float64).float(),
    )


def harmonize_masked(blocks) -> bool:
    """Rebuild the masked grids of host blocks on one common nominal grid
    (the earliest anchor, the mean interval), so that blocks staged apart
    share one window structure; widths may differ, validity covers the
    rest. False (blocks untouched) when the grids cannot be reconciled."""
    real = [b for b in blocks if b.n_series > 0]
    if not real or len({b.base_ms for b in real}) != 1:
        return False
    base = real[0].base_ms
    ints, anchors = [], []
    for b in real:
        # a block's grid evidence: its masked grid, or its (near-)regular grid
        if b.mgrid is not None:
            src = np.asarray(b.mgrid.nominal_ts)[: b.mgrid.n_valid]
        elif b.regular_ts is not None or b.nominal_ts is not None:
            m = int(np.asarray(b.lens)[0])
            grid = b.regular_ts if b.regular_ts is not None else b.nominal_ts
            src = np.asarray(grid)[:m]
        else:
            return False
        src = src.astype(np.int64)
        if len(src) < 2:
            return False
        d = np.diff(src)
        if (d <= 0).any():
            return False
        est = float(np.median(d))
        k = np.rint(d / est)
        if est <= 0 or (k < 1).any():
            return False
        ints.append(float(d.sum()) / float(k.sum()))
        anchors.append(int(src[0]))
    interval = float(np.mean(ints))
    if interval <= 0 or max(abs(x - interval) for x in ints) > 0.01 * interval:
        return False
    t0_abs = float(min(anchors) + base)
    rebuilt = []
    for b in real:
        ts_np = np.asarray(b.ts)
        lens = np.asarray(b.lens)
        cleaned = [(ts_np[i, : lens[i]].astype(np.int64) + base, None)
                   for i in range(b.n_series)]
        mg = _build_masked_grid(cleaned, base, np.asarray(b.vals),
                                np.asarray(b.raw) if b.raw is not None else None,
                                lens, b.ts.shape[1], b.vals.shape[0], grid=(interval, t0_abs))
        if mg is None:
            return False
        rebuilt.append(mg)
    md = max(mg.maxdev_ms for mg in rebuilt)
    if 2 * md >= interval:
        return False
    width = max(mg.n_valid for mg in rebuilt)
    if any(width > mg.cc.shape[1] for mg in rebuilt):
        return False  # a block cannot advertise slots its sidecar cannot hold
    for b, mg in zip(real, rebuilt):
        T = len(mg.nominal_ts)
        R = np.rint((t0_abs - base) + np.arange(T, dtype=np.float64) * interval).astype(np.int64)
        nominal = np.full(T, TS_PAD, dtype=np.int32)
        nominal[:width] = R[:width].astype(np.int32)
        mg.nominal_ts = nominal
        mg.n_valid = width
        mg.maxdev_ms = md
        b.mgrid = mg
        b.__dict__.pop("masked_matrices_memo", None)
    return True


@dataclass
class StagedBlock:
    """One staged window block: everything the range kernel needs. The
    arrays are numpy on the host until ``to_device`` moves them."""

    ts: np.ndarray | torch.Tensor  # [S, T] int32 ms offsets from base_ms; TS_PAD in padding
    # [S, T] f32 (counters: reset-corrected minus baseline), or [S, T, B]
    # raw cumulative bucket counts of a histogram block
    vals: np.ndarray | torch.Tensor
    lens: np.ndarray | torch.Tensor  # [S] int32 valid sample count per series
    base_ms: int  # absolute ms of offset 0
    baseline: np.ndarray | torch.Tensor  # [S] ([S, B] histograms) f32 value offset (else 0)
    n_series: int  # real series count (<= S)
    part_refs: list  # (shard_num, part_id) per real series row
    raw: np.ndarray | torch.Tensor | None = None  # [S, T] f32 raw values (counters only)
    # regular grid: every real series shares ONE timestamp vector and one
    # length, so the window bounds are series-independent (host numpy)
    regular_ts: np.ndarray | None = None  # [T] int32 shared offsets, or None
    # near-regular grid: equal sample counts, each sample within half the
    # minimum nominal interval of a shared nominal grid (host numpy). The
    # deviations stay on the host (the live-edge mirror): the jitter kernel
    # takes each one as ts - nominal_ts, which equals ts_dev exactly
    nominal_ts: np.ndarray | None = None  # [T] int32 shared nominal offsets
    ts_dev: np.ndarray | None = None  # [S, T] f32 per-sample deviation (ms)
    maxdev_ms: int = 0  # bound on |ts - nominal|
    # near-regular grid with missed scrapes: the slot-aligned sidecar, or
    # (``mgrid_deferred``) built where the block lies the first time the
    # masked rung reads it (``sidecar``)
    mgrid: MaskedGrid | None = None
    mgrid_deferred: bool = False
    # callbacks ``hook(block, nbytes)`` of the caches holding the block,
    # told when a deferred sidecar adds ``nbytes`` to it
    grow_hooks: list = field(default_factory=list, repr=False)
    # f64 state for exact appends: the unrounded per-series baseline
    # (shifted and corrected modes; the f32 baseline rounds by up to 64 at
    # 1e9) and, for corrected counters, (last raw, last corrected) value
    base64: np.ndarray | None = field(default=None, repr=False)
    cont: tuple | None = field(default=None, repr=False)
    # host mirrors kept by to_device(keep_host=True) / keep_mirrors(): the
    # append repairs write the new columns here. Always copies, never the
    # arrays a kernel reads: on the CPU torch.as_tensor(a).to("cpu")
    # aliases numpy memory, and an append would rewrite the old block.
    h_ts: np.ndarray | None = field(default=None, repr=False)
    h_vals: np.ndarray | None = field(default=None, repr=False)
    h_lens: np.ndarray | None = field(default=None, repr=False)
    h_raw: np.ndarray | None = field(default=None, repr=False)
    h_dev: np.ndarray | None = field(default=None, repr=False)
    # a device copy's host-staged source (``device_copy``): what host-side
    # readers (the f64 timestamp, scan accounting) read instead of the card
    host_block: "StagedBlock | None" = field(default=None, repr=False)

    @property
    def shape(self):
        return tuple(self.ts.shape)

    def keep_mirrors(self) -> "StagedBlock":
        """Copy the host arrays into the mutable mirrors the append repairs
        write (the block must still be on the host); returns self."""
        self.h_ts = np.array(self.ts, copy=True)
        self.h_vals = np.array(self.vals, copy=True)
        self.h_lens = np.array(self.lens, copy=True)
        self.h_raw = np.array(self.raw, copy=True) if self.raw is not None else None
        self.h_dev = np.array(self.ts_dev, copy=True) if self.ts_dev is not None else None
        return self

    def to_device(self, device, keep_host: bool = False) -> "StagedBlock":
        """Move the block's arrays to ``device``; returns self for chaining.
        ``keep_host`` first keeps the host mirrors, so the block can be
        extended under live ingest instead of restaged."""
        if keep_host:
            self.keep_mirrors()

        def put(a):
            return torch.as_tensor(a).to(device)

        self.ts = put(self.ts)
        self.vals = put(self.vals)
        self.lens = put(self.lens)
        self.baseline = put(self.baseline)
        if self.raw is not None:
            self.raw = put(self.raw)
        if self.mgrid is not None:
            self.mgrid = self.mgrid.device_copy(device)
        return self


def device_copy(block: StagedBlock, device) -> StagedBlock:
    """A copy of a host-staged block's arrays on ``device`` (one upload)
    with its grid class and the masked sidecar (not the jitter deviations,
    which the kernel derives), linked to the host block (``host_block``);
    the host block is left as it is. A deferred sidecar stays deferred:
    ``sidecar`` builds it on ``device`` for this copy alone, the first time
    the masked rung reads it. On the CPU the tensors share the host arrays'
    memory, which no append rewrites (repairs build new arrays)."""

    def put(a):
        return None if a is None else torch.as_tensor(a).to(device)

    mgrid = block.mgrid.device_copy(device) if block.mgrid is not None else None
    return StagedBlock(
        put(block.ts), put(block.vals), put(block.lens), block.base_ms, put(block.baseline),
        block.n_series, block.part_refs, raw=put(block.raw), regular_ts=block.regular_ts,
        nominal_ts=block.nominal_ts, maxdev_ms=block.maxdev_ms, mgrid=mgrid,
        mgrid_deferred=block.mgrid_deferred and mgrid is None, host_block=block,
    )


_SIDECAR_LOCK = threading.Lock()


def sidecar(block: StagedBlock) -> "MaskedGrid | None":
    """The block's masked sidecar, built on the block's device the first
    time a caller asks for a deferred one (the masked rung's ladders,
    ``aggregations.grid_variant`` and ``kernels.tree_rung``, and nothing
    else), from the host arrays it was staged from: a device copy's
    ``host_block``, the mirrors ``to_device(keep_host=True)`` keeps, else
    one fetch of its own arrays. Memoized on the block; the caches holding
    it are told the bytes it adds (``grow_hooks``). None where the grid is
    not holey, and for a host-staged block (numpy), whose device copies
    build their own."""
    if not block.mgrid_deferred or not isinstance(block.vals, torch.Tensor):
        return block.mgrid
    with _SIDECAR_LOCK:
        if block.mgrid_deferred:
            before = staged_nbytes(block)
            device = block.vals.device if isinstance(block.vals, torch.Tensor) else None
            block.mgrid = masked_of(_host_arrays(block), device)
            block.mgrid_deferred = False
            grown = staged_nbytes(block) - before
            for hook in list(block.grow_hooks):
                hook(block, grown)
    return block.mgrid


def _host_arrays(block: StagedBlock) -> StagedBlock:
    """A host view of a block's ts, vals, lens and raw (``masked_of``'s
    inputs): the block itself on the host, its ``host_block``, its mirrors,
    or one fetch of the device arrays."""
    if not isinstance(block.ts, torch.Tensor):
        return block
    if block.host_block is not None:
        return block.host_block
    if block.h_ts is not None:
        ts, vals, lens, raw = block.h_ts, block.h_vals, block.h_lens, block.h_raw
    else:
        def fetch(a):
            return None if a is None else a.detach().cpu().numpy()

        ts, vals, lens, raw = (fetch(a) for a in (block.ts, block.vals, block.lens, block.raw))
    return StagedBlock(ts, vals, lens, block.base_ms, None, block.n_series, [], raw=raw)


def staged_nbytes(block: StagedBlock) -> int:
    """Bytes of every array a staged block holds, the masked sidecar's
    planes included (the caches' byte budgets); reads ``.nbytes``, so
    device tensors are never fetched."""
    arrays = (block.ts, block.vals, block.raw, block.baseline, block.lens, block.ts_dev)
    total = sum(int(a.nbytes) for a in arrays if a is not None)
    return total + (block.mgrid.nbytes() if block.mgrid is not None else 0)


def block_device(block: StagedBlock) -> str:
    """The device a block's arrays lie on, as the ledger labels it
    (``cpu`` for numpy or CPU tensors, else e.g. ``cuda:0``)."""
    v = block.vals
    return str(v.device) if isinstance(v, torch.Tensor) else "cpu"


def detect_shared_grid(out_ts: np.ndarray, lens: np.ndarray, n: int, T: int, S: int):
    """Shared-grid classification over packed [S, T] timestamp rows, the one
    rule for ``stage_series``, ``concat_blocks`` and ``block_from_arrays``.
    Returns ``(regular, nominal, ts_dev, maxdev)``:

    - regular [T] when every real series shares one exact timestamp vector;
    - else nominal [T] + ts_dev [S, T] + maxdev when every series has the
      same sample count and each sample lies within half the minimum
      nominal interval of the per-slot midrange grid;
    - (None, None, None, 0) otherwise."""
    if n <= 0 or not (lens[:n] == lens[0]).all() or lens[0] == 0:
        return None, None, None, 0
    if not (out_ts[:n] != out_ts[0]).any():
        return out_ts[0], None, None, 0
    if lens[0] < 2:
        return None, None, None, 0
    m = int(lens[0])
    real = out_ts[:n, :m].astype(np.int64)
    nom, dev, md = nominal_midrange(real)
    min_int = int(np.diff(nom).min()) if m >= 2 else 0
    if min_int > 0 and 2 * md < min_int:
        nominal = np.full(T, TS_PAD, dtype=np.int32)
        nominal[:m] = nom.astype(np.int32)
        ts_dev = np.zeros((S, T), dtype=np.float32)
        ts_dev[:n, :m] = dev.astype(np.float32)
        return None, nominal, ts_dev, md
    return None, None, None, 0


def grid_class(block, build: bool = True) -> str:
    """``regular`` (exact shared grid) > ``jitter`` (near-regular) >
    ``holes`` (near-regular with missed scrapes, the masked sidecar) >
    ``irregular``; the kernel ladders key on it. Telling holes from
    irregular builds a deferred sidecar (``sidecar``); with ``build`` false
    such a block is ``unclassified``."""
    if block.regular_ts is not None:
        return "regular"
    if block.nominal_ts is not None:
        return "jitter"
    if block.mgrid_deferred and not build:
        return "unclassified"
    if sidecar(block) is not None:
        return "holes"
    return "irregular"


def nominal_midrange(real: np.ndarray):
    """Nominal grid of near-regular data: the per-column midrange over
    [n, m] actual timestamps. Returns (nominal int64 [m], deviations int64
    [n, m], maxdev int)."""
    nom = (real.min(axis=0) + real.max(axis=0)) // 2
    dev = real - nom[None, :]
    return nom, dev, int(np.abs(dev).max())


def counter_correct(vals: np.ndarray) -> np.ndarray:
    """f64 prefix-sum reset correction: add the prior raw value at each drop
    (Prometheus semantics; reference CorrectingDoubleVectorReader:308)."""
    v = vals.astype(np.float64)
    if len(v) < 2:
        return v
    drops = np.where(v[1:] < v[:-1], v[:-1], 0.0)
    corr = np.concatenate([[0.0], np.cumsum(drops)])
    return v + corr


def stage_series(
    series: list[tuple[np.ndarray, np.ndarray]],
    base_ms: int,
    part_refs: list | None = None,
    subtract_baseline: bool = False,
    counter_corrected: bool = False,
    diff_encode: bool = False,
    time_headroom: int = 0,
    sidecar: bool = True,
) -> StagedBlock:
    """Build a host StagedBlock from per-series (ts_ms int64, values f64)
    pairs. Four modes: raw values (default), ``counter_corrected``
    (reset-corrected minus the first value, raw values alongside),
    ``diff_encode`` (slot i holds the f64-exact difference v[i] - v[i-1],
    slot 0 holds 0: changes/resets/idelta are functions of the differences)
    and ``subtract_baseline`` (raw minus the first value, no correction).
    ``time_headroom`` extra columns let live-edge appends land before the
    padded width forces a restage. The block's grid is classified
    (``detect_shared_grid``, else the masked grid on the host's threads, or
    with ``sidecar`` false left to the block's device copies:
    ``mgrid_deferred``)."""
    n = len(series)
    cleaned: list[tuple[np.ndarray, np.ndarray]] = []
    maxlen = 1
    for ts, vals in series:
        keep = ~np.isnan(vals)
        if not keep.all():
            ts, vals = ts[keep], vals[keep]
        cleaned.append((ts, vals))
        maxlen = max(maxlen, len(ts))
    S = pad_series(max(n, 1))
    T = pad_time(maxlen + max(time_headroom, 0))
    out_ts = np.full((S, T), TS_PAD, dtype=np.int32)
    out_vals = np.zeros((S, T), dtype=np.float32)
    out_raw = np.zeros((S, T), dtype=np.float32) if counter_corrected else None
    lens = np.zeros(S, dtype=np.int32)
    baseline = np.zeros(S, dtype=np.float32)
    # f64 continuation state (last raw, last corrected value) and the
    # unrounded baseline, so appends continue the correction exactly
    cont_raw = np.zeros(S, dtype=np.float64)
    cont_corr = np.zeros(S, dtype=np.float64)
    base64 = np.zeros(S, dtype=np.float64)
    for i, (ts, vals) in enumerate(cleaned):
        m = len(ts)
        lens[i] = m
        if m == 0:
            continue
        out_ts[i, :m] = (ts - base_ms).astype(np.int32)
        if counter_corrected:
            b = np.float64(vals[0])
            baseline[i] = b
            base64[i] = b
            corrected = counter_correct(vals)
            cont_raw[i] = vals[-1]
            cont_corr[i] = corrected[-1]
            out_vals[i, :m] = (corrected - b).astype(np.float32)
            # raw rides along unshifted: it only feeds the zero-crossing cap,
            # which engages only for raw values near zero, where f32 is exact
            out_raw[i, :m] = vals.astype(np.float32)
        elif diff_encode:
            out_vals[i, 1:m] = np.diff(vals.astype(np.float64)).astype(np.float32)
        elif subtract_baseline:
            b = np.float64(vals[0])
            baseline[i] = b
            base64[i] = b
            out_vals[i, :m] = (vals.astype(np.float64) - b).astype(np.float32)
        else:
            out_vals[i, :m] = vals.astype(np.float32)
    regular, nominal, ts_dev, maxdev = detect_shared_grid(out_ts, lens, n, T, S)
    mgrid = None
    holey = n > 1 and regular is None and nominal is None
    if holey and sidecar:
        # unequal counts, or equal counts on misaligned slots: the masked grid
        mgrid = _build_masked_grid(cleaned[:n], base_ms, out_vals, out_raw, lens, T, S)
    block = StagedBlock(out_ts, out_vals, lens, base_ms, baseline, n,
                        part_refs or [], raw=out_raw, regular_ts=regular,
                        nominal_ts=nominal, ts_dev=ts_dev, maxdev_ms=maxdev, mgrid=mgrid,
                        mgrid_deferred=holey and not sidecar)
    if counter_corrected or subtract_baseline:
        block.base64 = base64
    if counter_corrected:
        block.cont = (cont_raw, cont_corr)
    return block


def stage_step_rows(values: np.ndarray, times_ms: np.ndarray, base_ms: int,
                    counter_corrected: bool = False) -> StagedBlock:
    """``stage_series`` of the rows of a step grid, as a subquery re-stages
    its inner result: row i of ``values`` (f32 [n, J], NaN = absent) at
    ``times_ms`` (int64 [J]) becomes the series of its non-NaN steps, raw
    or ``counter_corrected``. No loop per row: the kept steps of every row
    move to the left in order with their times (one column selection where
    all rows keep the same steps, else a stable sort of each row's absent
    flags), and the counter correction runs on the compacted [n, maxlen]
    f64 matrix in ``counter_correct``'s order of operations (a row's drops
    summed left to right by ``np.cumsum``, added to its values, which a row
    of one sample keeps as they are), so the block is bit-equal to
    ``stage_series(..., sidecar=False)`` over the same ``(times[keep],
    row[keep])`` pairs: a masked grid is built by the block's device copy."""
    v = np.asarray(values, dtype=np.float32)
    times_ms = np.asarray(times_ms, dtype=np.int64)
    n = v.shape[0]
    keep = ~np.isnan(v)
    m = keep.sum(axis=1).astype(np.int32)
    maxlen = max(1, int(m.max()) if n else 0)
    if n and m[0] and not (keep != keep[0]).any():
        cols = np.nonzero(keep[0])[0]
        cv, ct = v[:, cols], np.broadcast_to(times_ms[cols], (n, len(cols)))
    else:
        order = np.argsort(~keep, axis=1, kind="stable")[:, :maxlen]  # kept steps first
        cv, ct = np.take_along_axis(v, order, axis=1), times_ms[order]
    absent = np.arange(cv.shape[1]) >= m[:, None]  # the tail past each row's kept steps
    S, T, w = pad_series(max(n, 1)), pad_time(maxlen), cv.shape[1]
    out_ts = np.full((S, T), TS_PAD, dtype=np.int32)
    out_ts[:n, :w] = (ct - base_ms).astype(np.int32)
    out_ts[:n, :w][absent] = TS_PAD
    out_vals = np.zeros((S, T), dtype=np.float32)
    lens = np.zeros(S, dtype=np.int32)
    lens[:n] = m
    baseline = np.zeros(S, dtype=np.float32)
    if not counter_corrected:
        out_vals[:n, :w] = cv
        out_vals[:n, :w][absent] = 0.0
        block = StagedBlock(out_ts, out_vals, lens, base_ms, baseline, n, [])
    else:
        packed = cv.astype(np.float64)  # NaN in the tail: no drop, no valid slot reads it
        drops = np.where(packed[:, 1:] < packed[:, :-1], packed[:, :-1], 0.0)
        corrected = np.zeros_like(packed)
        np.cumsum(drops, axis=1, out=corrected[:, 1:])
        corrected += packed
        one = m == 1
        corrected[one] = packed[one]  # counter_correct returns a lone sample as it is
        b = packed[:, :1]
        out_vals[:n, :w] = corrected - b
        out_vals[:n, :w][absent] = 0.0
        out_raw = np.zeros((S, T), dtype=np.float32)
        out_raw[:n, :w] = cv
        out_raw[:n, :w][absent] = 0.0
        real = m > 0
        last = np.maximum(m - 1, 0)[:, None]
        baseline[:n] = np.where(real, b[:, 0], 0.0)
        base64 = np.zeros(S, dtype=np.float64)
        base64[:n] = np.where(real, b[:, 0], 0.0)
        cont_raw = np.zeros(S, dtype=np.float64)
        cont_corr = np.zeros(S, dtype=np.float64)
        cont_raw[:n] = np.where(real, np.take_along_axis(packed, last, axis=1)[:, 0], 0.0)
        cont_corr[:n] = np.where(real, np.take_along_axis(corrected, last, axis=1)[:, 0], 0.0)
        block = StagedBlock(out_ts, out_vals, lens, base_ms, baseline, n, [], raw=out_raw)
        block.base64 = base64
        block.cont = (cont_raw, cont_corr)
    block.regular_ts, block.nominal_ts, block.ts_dev, block.maxdev_ms = detect_shared_grid(
        out_ts, lens, n, T, S)
    block.mgrid_deferred = n > 1 and block.regular_ts is None and block.nominal_ts is None
    return block


def masked_of(block: StagedBlock, device=None) -> MaskedGrid | None:
    """The masked sidecar of a host block whose grid is neither regular nor
    jittered (``stage_series``' rule, from the packed rows; its planes
    built on ``device``), else None."""
    n = block.n_series
    if n <= 1 or block.regular_ts is not None or block.nominal_ts is not None:
        return None
    if block.vals.ndim != 2 or int(block.lens[:n].min()) < 1:
        return None
    lens = np.asarray(block.lens[:n], np.int64)
    packed = np.arange(block.ts.shape[1])[None, :] < lens[:, None]
    flat = block.ts[:n][packed].astype(np.int64) + block.base_ms  # row by row, in order
    return _build_masked_grid((flat, lens), block.base_ms, block.vals, block.raw,
                              block.lens, block.ts.shape[1], block.ts.shape[0],
                              device=device)


def stage_histogram_series(series: list[tuple[np.ndarray, np.ndarray]], base_ms: int,
                           n_buckets: int, part_refs: list | None = None) -> StagedBlock:
    """``stage_series`` for histograms: per-series (ts_ms int64, [n, B]
    bucket counts) pairs -> a host block with vals [S, T, B] and baseline
    [S, B] (zeros: histogram columns stage raw), its grid classified as
    scalar staging does."""
    n = len(series)
    maxlen = max([1] + [len(ts) for ts, _ in series])
    S = pad_series(max(n, 1))
    T = pad_time(maxlen)
    out_ts = np.full((S, T), TS_PAD, dtype=np.int32)
    out_vals = np.zeros((S, T, n_buckets), dtype=np.float32)
    lens = np.zeros(S, dtype=np.int32)
    for i, (ts, vals) in enumerate(series):
        m = len(ts)
        lens[i] = m
        if m:
            out_ts[i, :m] = (ts - base_ms).astype(np.int32)
            out_vals[i, :m] = vals.astype(np.float32)
    regular, nominal, ts_dev, maxdev = detect_shared_grid(out_ts, lens, n, T, S)
    return StagedBlock(out_ts, out_vals, lens, base_ms, np.zeros((S, n_buckets), np.float32),
                       n, part_refs or [], regular_ts=regular, nominal_ts=nominal,
                       ts_dev=ts_dev, maxdev_ms=maxdev)


def block_from_arrays(ts, vals, lens, base_ms: int, baseline, n_series: int,
                      raw=None, device="cuda") -> StagedBlock:
    """A device block from plain arrays (numpy or anything ``np.asarray``
    takes) — how a block staged elsewhere, such as a JAX ``StagedBlock``,
    is carried into the port. Its grid is classified as staging does."""
    ts = np.asarray(ts, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    lens = np.asarray(lens, dtype=np.int32)
    if ts.ndim != 2 or vals.shape != ts.shape or lens.shape != (ts.shape[0],):
        raise ValueError(f"block shapes disagree: ts {ts.shape}, vals {vals.shape}, lens {lens.shape}")
    if raw is not None:
        raw = np.asarray(raw, dtype=np.float32)
        if raw.shape != ts.shape:
            raise ValueError(f"raw shape {raw.shape} != ts shape {ts.shape}")
    S, T = ts.shape
    regular, nominal, ts_dev, maxdev = detect_shared_grid(ts, lens, int(n_series), T, S)
    block = StagedBlock(
        ts, vals, lens, int(base_ms), np.asarray(baseline, dtype=np.float32),
        int(n_series), [], raw=raw, regular_ts=regular, nominal_ts=nominal,
        ts_dev=ts_dev, maxdev_ms=maxdev,
    )
    block.mgrid_deferred = True  # built on ``device`` (to_device)
    return block.to_device(device)


def stage_from_shard(shard, part_ids, column: str, start_ms: int, end_ms: int,
                     mode: str) -> StagedBlock:
    """Gather [start_ms, end_ms] samples for part_ids from a shard and stage
    them on the host. ``mode`` is ``"corrected"``, ``"shifted"``, ``"diff"``
    or ``"raw"`` (see plans._stage_mode_for_function); a histogram column
    stages raw ``[S, T, B]`` (``stage_histogram_series``) whatever the mode.

    A small-to-medium block whose range reaches past its newest sample (the
    live edge) gets 256 columns of headroom, so appends land before the
    padded width forces a restage; historical ranges never append and
    never pay the wider T. A masked grid is not built here but by the
    block's device copies (``device_copy``); a superblock builds its own
    once over its rows (``concat_blocks``)."""
    series, refs = [], []
    for pid in part_ids:
        part = shard.partition(int(pid))
        series.append(part.samples_in_range(start_ms, end_ms, column))
        refs.append((shard.shard_num, int(pid)))
    widths = {v.shape[1] for _, v in series if v.ndim == 2}
    if widths:
        return stage_histogram_series(series, start_ms, widths.pop(), refs)
    newest = max((int(ts[-1]) for ts, _ in series if len(ts)), default=None)
    live_edge = newest is not None and end_ms >= newest

    def stage(sr):
        return stage_series(
            sr, start_ms, refs,
            counter_corrected=mode == "corrected",
            subtract_baseline=mode == "shifted",
            diff_encode=mode == "diff",
            time_headroom=256 if live_edge and len(series) <= 8192 else 0,
            sidecar=False,
        )

    block = stage(series)
    if block.regular_ts is None and block.nominal_ts is None and block.n_series > 1:
        aligned = _slot_align(shard, part_ids, column, series, start_ms, end_ms)
        if aligned is not None:
            block = stage(aligned)
    return block


def _slot_align(shard, part_ids, column, series, start_ms: int, end_ms: int):
    """Repair the ragged edges of a near-regular selection (the JAX
    package's rule). A jittered sample just outside [start_ms, end_ms] is
    read for some series and not others, so the counts differ by one or
    two and the grid is not detected as jittered. Re-read with a margin of
    one interval, map every sample to its nominal slot and trim every
    series to the common slots that can reach a window: a slot at nominal
    g <= start - maxdev has ts <= start for every series, and one at g >
    end + maxdev has ts > end. Returns the aligned series, or None when the
    data is not near-regular (the packed staging stays)."""
    lens = [len(t) for t, _ in series]
    if not lens or min(lens) < 2 or max(lens) - min(lens) > 2:
        return None
    ref = series[int(np.argmax(lens))][0]
    diffs = np.diff(ref)
    # the endpoints' estimate: a sample's jitter costs O(maxdev / n)
    interval = float(ref[-1] - ref[0]) / (len(ref) - 1)
    if interval <= 0 or (np.abs(diffs - interval) > 0.45 * interval).any():
        return None
    anchor = float(ref[0])
    margin = int(round(interval))
    per = []
    md = 0.0
    for pid in part_ids:
        ts, v = shard.partition(int(pid)).samples_in_range(start_ms - margin, end_ms + margin,
                                                           column)
        if v.ndim == 2 or len(ts) < 2:
            return None
        if np.isnan(v).any():
            return None  # staleness holes: the packed staging handles them
        k = np.rint((ts.astype(np.float64) - anchor) / interval).astype(np.int64)
        if (np.diff(k) != 1).any():
            return None  # missed scrapes: not slot-contiguous
        md = max(md, float(np.abs(ts - (anchor + k * interval)).max()))
        per.append((k, ts, v))
    if 2.0 * md >= 0.9 * interval:
        return None
    # the slots that can reach a window of the staged range
    k_need_lo = int(np.ceil((start_ms - md - anchor) / interval - 1e-9))
    while anchor + k_need_lo * interval <= start_ms - md:
        k_need_lo += 1
    k_need_hi = int(np.floor((end_ms + md - anchor) / interval + 1e-9))
    while anchor + k_need_hi * interval > end_ms + md:
        k_need_hi -= 1
    # clamped to the slots where data exists at all (a live-edge end past
    # every newest sample must not demand future slots)
    k_need_lo = max(k_need_lo, min(k[0] for k, _, _ in per))
    k_need_hi = min(k_need_hi, max(k[-1] for k, _, _ in per))
    k_lo = max(k[0] for k, _, _ in per)
    k_hi = min(k[-1] for k, _, _ in per)
    if k_lo > k_need_lo or k_hi < k_need_hi or k_need_hi < k_need_lo:
        return None  # a needed slot is missing for some series
    out = []
    width = k_need_hi - k_need_lo + 1
    for k, ts, v in per:
        o = k_need_lo - int(k[0])
        out.append((ts[o : o + width], v[o : o + width]))
    return out


# timings and sizes of the last superblock extension that appended columns:
# set by _append_to_parts (device blocks only), read by chip_smoke.py
LAST_EXTENSION: dict = {}


def append_to_block(shard, block: StagedBlock, part_ids, column: str, end_ms: int,
                    mode: str, dirty_lo: int | None = None) -> StagedBlock | None:
    """Append the samples that arrived after a shard's staged ``block``
    (the live-edge path: each scrape lands just past the staged head).
    ``dirty_lo`` is the cache entry's accumulated dirt floor
    (``StageEntry.dirty_lo``): the repair declines when it reaches below
    the staged heads. None when the selection changed or a precondition
    of ``_append_to_parts`` fails (the caller restages)."""
    refs = [(shard.shard_num, int(p)) for p in part_ids]
    if refs != list(block.part_refs):
        return None
    parts = [shard.partition(int(p)) for p in part_ids]
    return _append_to_parts(parts, block, column, end_ms, mode, dirty_lo=dirty_lo)


def extend_superblock(memstore, dataset: str, block: StagedBlock, column: str,
                      end_ms: int, mode: str, les=None) -> StagedBlock | None:
    """``append_to_block`` lifted to the cross-shard superblock: resolves
    every ``part_refs`` row to its live partition and appends through the
    same core, so the warm query stays one launch under live ingest. The
    caller has proved the row set unchanged (fresh lookups and the shards'
    effect logs). ``les`` is a histogram superblock's bucket bounds: the
    extension declines when a member partition's scheme no longer matches
    them (appended rows would land on the wrong bounds). None when a
    precondition fails (the caller restages)."""
    parts = []
    try:
        for sn, pid in block.part_refs:
            parts.append(memstore.shard(dataset, sn).partitions[int(pid)])
    except KeyError:
        return None
    if les is not None and any(p.bucket_les is None or not same_scheme(p.bucket_les, les)
                               for p in parts):
        return None
    return _append_to_parts(parts, block, column, end_ms, mode)


def _with_columns(old, mirror: np.ndarray, n: int, m: int, k: int):
    """``old`` with its columns [:n, m:m+k] taken from ``mirror``, as a new
    array on old's device; ``old`` itself is never written. On the card
    that is a device-side clone plus an upload of the n x k new values
    only."""
    if isinstance(old, torch.Tensor):
        new = old.clone()
        new[:n, m : m + k] = torch.from_numpy(
            np.ascontiguousarray(mirror[:n, m : m + k])).to(old.device)
        return new
    new = old.copy()
    new[:n, m : m + k] = mirror[:n, m : m + k]
    return new


def _append_to_parts(parts, block: StagedBlock, column: str, end_ms: int, mode: str,
                     dirty_lo: int | None = None) -> StagedBlock | None:
    """Uniform-batch append core of ``append_to_block`` and
    ``extend_superblock``. ``parts`` are the live partitions in the block's
    ``part_refs`` order.

    Writes the host mirrors in place, but only at columns at or past the
    old head; the small per-series state (h_lens, cont) is copied on
    write, so a reader holding the old block keeps a consistent head-m
    view. Returns a new block whose arrays are the old ones with the new
    columns written in (``_with_columns``): the old block's arrays are
    never written, so a query in flight on it sees what it saw, and the
    caller swaps the new block into its cache entry. Returns the block
    itself when nothing new is in range, and None when a precondition
    fails:

    - the mode is raw, shifted or corrected (diff continuation needs state
      the block does not carry), and the block is host-mirrored on a
      regular or jittered shared grid; a histogram [S, T, B] block only
      in raw mode on a regular grid;
    - every series gains the same count of new samples: identical
      timestamps on a regular grid, near-nominal ones (the jitter bound
      re-checked over the extended grid) on a jittered grid; and the
      padded T still fits."""
    t_host = time.perf_counter()
    if mode not in ("raw", "shifted", "corrected"):
        return None
    if mode == "corrected" and block.cont is None:
        return None
    if mode in ("corrected", "shifted") and block.base64 is None:
        return None  # exact f64 baselines required (f32 rounds by 64 at 1e9)
    jittered = block.regular_ts is None and block.nominal_ts is not None
    if block.h_ts is None:
        return None
    if block.regular_ts is None and not jittered:
        return None
    if jittered and block.h_dev is None:
        return None
    if block.n_series == 0:
        return None
    is_hist = block.h_vals.ndim == 3
    if is_hist and (mode != "raw" or jittered):
        return None
    n = block.n_series
    lens = block.h_lens
    m = int(lens[0])
    if m == 0 or not (lens[:n] == m).all():
        return None
    base = block.base_ms
    grid = np.asarray(block.nominal_ts if jittered else block.regular_ts)
    last_nom = int(grid[m - 1]) + base
    # jittered: each series' head sits at last_nom plus its own deviation,
    # so the read starts per series (an in-order sample in another series'
    # gap must not be skipped: it shows up as a non-uniform batch)
    if jittered:
        dev_last = block.h_dev[:n, m - 1].astype(np.int64)
        read_from = [last_nom + int(d) + 1 for d in dev_last]
    else:
        read_from = [last_nom + 1] * n
    # the append-only repair is right only when every dirtying sample sits
    # at or past the staged heads
    if dirty_lo is not None and dirty_lo < min(read_from) - 1:
        return None
    # the tails are gathered with no per-series checks: at 100k series the
    # per-call overhead is the cost, so the checks run vectorized over the
    # stacked [n, k] batch, with a per-series pass only for an odd batch
    t_read = time.perf_counter()
    per = [p.tail_samples(read_from[i], end_ms, column) for i, p in enumerate(parts)]
    read_s = time.perf_counter() - t_read
    per_ts = [ts for ts, _ in per]
    per_vals = [v for _, v in per]
    V0 = TS0 = None
    k = len(per_ts[0])
    uniform = all(len(ts) == k for ts in per_ts)
    if uniform and k > 0:
        V0 = np.stack(per_vals)
        if V0.ndim != (3 if is_hist else 2):
            uniform = False
            V0 = None
        elif is_hist and V0.shape[2] != block.h_vals.shape[2]:
            return None  # the bucket scheme's width changed: restage
        elif not is_hist and np.isnan(V0).any():
            uniform = False  # staleness markers: per-series filtering
            V0 = None
        else:
            TS0 = np.stack(per_ts)
            if not jittered and (TS0 != TS0[0]).any():
                return None  # the regular grid would not stay shared
    if not uniform:
        new_ts = None
        per_vals = []
        per_ts = []
        for ts, vals in per:
            if vals.ndim != (2 if is_hist else 1):
                return None
            if is_hist:
                if vals.shape[1] != block.h_vals.shape[2]:
                    return None  # the bucket scheme's width changed: restage
            else:
                keep = ~np.isnan(vals)
                if not keep.all():
                    ts, vals = ts[keep], vals[keep]
            if new_ts is None:
                new_ts = ts
            elif len(ts) != len(new_ts):
                return None  # appended counts diverge
            elif not jittered and (ts != new_ts).any():
                return None  # the regular grid would not stay shared
            per_vals.append(vals)
            per_ts.append(ts)
        k = 0 if new_ts is None else len(new_ts)
    if k == 0:
        return block  # nothing new in this block's range: still clean
    new_ts = per_ts[0]
    T = block.h_ts.shape[1]
    if m + k > T:
        return None  # padded width exhausted: restage with a bigger T
    if jittered:
        TS = (TS0 if TS0 is not None else np.stack(per_ts)).astype(np.int64)
        if (np.diff(TS, axis=1) <= 0).any():
            return None
        nom_new, dev_new, md_new = nominal_midrange(TS)
        md = max(md_new, int(block.maxdev_ms))
        ext = np.concatenate([grid[:m].astype(np.int64) + base, nom_new])
        d = np.diff(ext)
        if (d <= 0).any() or 2 * md >= int(d.min()):
            return None  # the jitter bound fails on the extended grid
        off = nom_new - base
        OFF = (TS - base).astype(np.int64)
        if OFF.max() >= 2**31 - 1:
            return None
    else:
        off = (new_ts - base).astype(np.int64)
        if off.max() >= 2**31 - 1 or off.min() <= int(grid[m - 1]):
            return None
    off32 = off.astype(np.int32)
    V = (V0 if V0 is not None else np.stack(per_vals)).astype(np.float64)  # [n, k(, B)]
    if jittered:
        block.h_ts[:n, m : m + k] = OFF.astype(np.int32)
        block.h_dev[:n, m : m + k] = dev_new.astype(np.float32)
    else:
        block.h_ts[:n, m : m + k] = off32[None, :]
    if mode == "raw":
        block.h_vals[:n, m : m + k] = V.astype(block.h_vals.dtype)
    elif mode == "shifted":
        b = block.base64[:n]
        block.h_vals[:n, m : m + k] = (V - b[:, None]).astype(block.h_vals.dtype)
    new_cont = None
    if mode == "corrected":
        # exact f64 continuation from the stored state, copied on write: the
        # old block stays frozen at head m
        cont_raw, cont_corr = block.cont
        prev = np.concatenate([cont_raw[:n, None], V[:, :-1]], axis=1)
        drops = np.where(V < prev, prev, 0.0)
        corr = cont_corr[:n, None] + np.cumsum(V - prev + drops, axis=1)
        b = block.base64[:n]
        block.h_vals[:n, m : m + k] = (corr - b[:, None]).astype(block.h_vals.dtype)
        block.h_raw[:n, m : m + k] = V.astype(block.h_raw.dtype)
        new_cont = (cont_raw.copy(), cont_corr.copy())
        new_cont[0][:n] = V[:, -1]
        new_cont[1][:n] = corr[:, -1]
    # lens copied on write: the old block's lens never advance, so the
    # columns written above stay invisible to it
    new_lens = lens.copy()
    new_lens[:n] = m + k
    ext_grid = grid.copy()
    ext_grid[m : m + k] = off32
    t_dev = time.perf_counter()
    on_card = isinstance(block.ts, torch.Tensor) and block.ts.is_cuda
    if on_card:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    nb = StagedBlock(
        _with_columns(block.ts, block.h_ts, n, m, k),
        _with_columns(block.vals, block.h_vals, n, m, k),
        (torch.from_numpy(new_lens.copy()).to(block.lens.device)
         if isinstance(block.lens, torch.Tensor) else new_lens.copy()),
        base, block.baseline, n, list(block.part_refs),
        raw=(_with_columns(block.raw, block.h_raw, n, m, k) if block.raw is not None else None),
        regular_ts=None if jittered else ext_grid,
        nominal_ts=ext_grid if jittered else None,
        # the deviations stay on the host (no kernel of the port reads
        # them): the new block shares the mirror, read only below its head
        ts_dev=block.h_dev if jittered else None,
        maxdev_ms=md if jittered else 0,
        base64=block.base64,
        cont=new_cont if new_cont is not None else block.cont,
        h_ts=block.h_ts, h_vals=block.h_vals, h_lens=new_lens, h_raw=block.h_raw,
        h_dev=block.h_dev,
    )
    if isinstance(block.ts, torch.Tensor):
        mirrors = [block.h_ts, block.h_vals] + ([block.h_raw] if block.raw is not None else [])
        LAST_EXTENSION.clear()
        LAST_EXTENSION.update(
            series=n, columns=k, read_s=read_s, host_s=t_dev - t_host,
            device_wall_s=time.perf_counter() - t_dev,
            bytes_uploaded=sum(int(a[:n, m : m + k].nbytes) for a in mirrors)
            + int(new_lens.nbytes),
        )
        if on_card:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            LAST_EXTENSION["device_events"] = (ev0, ev1)
    for memo in ("group_ids_memo", "group_members_memo", "zero_gids_memo"):
        # groupings (and the quantile's member lists) are functions of the
        # unchanged series set: carrying the memos keeps an extended
        # superblock's query free of the O(S) regroup; the window-matrix
        # memo starts empty on the new grid
        if memo in block.__dict__:
            setattr(nb, memo, dict(block.__dict__[memo]))
    return nb


def concat_blocks(blocks) -> StagedBlock:
    """Row-concatenate host blocks into one padded superblock exactly:
    corrected values, raw sidecars, baselines and part refs carry over.
    All blocks must share base_ms. Histogram blocks ([S, T, B] vals,
    [S, B] baselines) concatenate the same way into ``[ΣS, T, B]``; they
    must already share one bucket scheme (``plans._unify_hist_blocks``).

    The shared regular grid survives when every non-empty block advertises
    the identical ``regular_ts``; otherwise the grid is detected again over
    the concatenated rows (members of different padded widths can still
    agree exactly, near-regular rows keep their ``jitter`` class, and rows
    with missed scrapes get one masked sidecar, ``holes``, which the
    superblock's device copy builds: ``mgrid_deferred``)."""
    real = [b for b in blocks if b.n_series > 0] or list(blocks[:1])
    if not real or len({b.base_ms for b in real}) != 1:
        raise ValueError("concat_blocks needs blocks that share one base_ms")
    T = max(b.ts.shape[1] for b in real)
    S = sum(b.n_series for b in real)
    Sp = pad_series(S)
    widths = {b.vals.shape[2] for b in real if b.vals.ndim == 3}
    is_hist = bool(widths)
    if is_hist and (len(widths) != 1 or any(b.vals.ndim != 3 for b in real)):
        raise ValueError("histogram blocks must share one bucket scheme before concat_blocks")
    B = (widths.pop(),) if is_hist else ()
    ts = np.full((Sp, T), TS_PAD, np.int32)
    vals = np.zeros((Sp, T) + B, np.float32)
    raw = np.zeros((Sp, T), np.float32) if any(b.raw is not None for b in real) else None
    lens = np.zeros(Sp, np.int32)
    baseline = np.zeros((Sp,) + B, np.float32)
    part_refs: list = []
    o = 0
    for b in real:
        k, t = b.n_series, b.ts.shape[1]
        ts[o : o + k, :t] = b.ts[:k]
        vals[o : o + k, :t] = b.vals[:k]
        if raw is not None:
            raw[o : o + k, :t] = (b.raw if b.raw is not None else b.vals)[:k]
        lens[o : o + k] = b.lens[:k]
        baseline[o : o + k] = b.baseline[:k]
        part_refs.extend(b.part_refs)
        o += k
    reg = real[0].regular_ts
    regular = None
    if reg is not None and all(
        b.regular_ts is not None and len(b.regular_ts) == len(reg)
        and not (b.regular_ts != reg).any()
        for b in real[1:]
    ):
        regular = reg
        if len(regular) < T:  # narrower padded blocks keep the shared grid
            regular = np.full(T, TS_PAD, np.int32)
            regular[: len(reg)] = reg
    nominal = ts_dev = None
    maxdev = 0
    if regular is None and S > 0:
        regular, nominal, ts_dev, maxdev = detect_shared_grid(ts, lens, S, T, Sp)
    out = StagedBlock(ts, vals, lens, real[0].base_ms, baseline, S, part_refs, raw=raw,
                      regular_ts=regular, nominal_ts=nominal, ts_dev=ts_dev,
                      maxdev_ms=maxdev)
    # one slot grid over the concatenated rows (members snapped apart would
    # not share one window structure), built once, by the superblock's
    # device copy (``to_device``)
    out.mgrid_deferred = (not is_hist and S > 1 and regular is None and nominal is None
                          and int(lens[:S].min()) >= 2)
    # the f64 append state rides along (a snapshot: the members' own state
    # moves on under their repairs), so the superblock can be extended
    if all(b.base64 is not None for b in real):
        out.base64 = _concat_rows([b.base64 for b in real], real, Sp)
    if all(b.cont is not None for b in real):
        out.cont = (_concat_rows([b.cont[0] for b in real], real, Sp),
                    _concat_rows([b.cont[1] for b in real], real, Sp))
    return out


def _concat_rows(arrays, blocks, Sp: int) -> np.ndarray:
    """The real rows of each block's per-series f64 array, stacked into
    one [Sp] array."""
    out = np.zeros(Sp, np.float64)
    o = 0
    for a, b in zip(arrays, blocks):
        out[o : o + b.n_series] = np.asarray(a)[: b.n_series]
        o += b.n_series
    return out


class SuperblockCache:
    """Cache of device-resident cross-shard superblocks keyed by the
    query's staging identity (selector filters, range, column, stage mode,
    shard set, device). Each entry stores the vector of member shard
    versions it was built from, so any ingest on any member shard makes it
    stale at its next lookup. A stale entry is kept: the interval-aware
    refresh (``peek``/``revalidate`` and the extension in
    ``plans.FusedAggregateExec``) may prove it still valid or extend it.
    LRU on hit, bounded by entry count and bytes; pinned keys are never
    evicted."""

    def __init__(self, max_entries: int = 8, max_bytes: int = 8 << 30):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._d: OrderedDict = OrderedDict()  # key -> (versions, value, nbytes)
        # per key: created time, hit count, last maintenance outcome
        self._meta: dict = {}
        # pinned key -> owner set: put()'s eviction skips pinned entries;
        # a key may be pinned before its entry is built
        self._pins: dict = {}
        self._lock = threading.Lock()
        self._flight = KeyedSingleFlight(max_keys=4 * max_entries, alive=lambda k: k in self._d)
        from ..ledger import LEDGER

        self.ledger = LEDGER.register(self, "superblock", walker=SuperblockCache._walk,
                                      name="superblock_cache",
                                      device_walker=SuperblockCache._walk_devices)

    def _blocks(self) -> list:
        with self._lock:
            values = [v for _, v, _ in self._d.values()]
        return [getattr(v, "block", v) for v in values]

    def _walk(self) -> int:
        """The cached superblocks' true bytes (the ledger's drift check)."""
        return sum(staged_nbytes(b) for b in self._blocks())

    def _walk_devices(self) -> dict:
        out: dict = {}
        for b in self._blocks():
            dev = block_device(b)
            out[dev] = out.get(dev, 0) + staged_nbytes(b)
        return out

    def _grown(self, key, block, nbytes: int) -> None:
        """A cached superblock's deferred sidecar was built (``sidecar``):
        its entry counts the bytes."""
        with self._lock:
            hit = self._d.get(key)
            if hit is None or getattr(hit[1], "block", hit[1]) is not block:
                return
            self._d[key] = (hit[0], hit[1], hit[2] + nbytes)
        self.ledger.alloc(nbytes, count=0)

    def build_lock(self, key) -> threading.Lock:
        """Per-key single flight for superblock builds: identical cold queries
        serialize here, so only one concatenates and uploads the
        superblock and the rest hit its entry."""
        return self._flight.lock(key)

    def get(self, key, versions: tuple):
        """The entry's value when it was stamped with ``versions``, else
        None (a stale entry stays for the refresh path)."""
        with self._lock:
            hit = self._d.get(key)
            if hit is None or hit[0] != versions:
                return None
            self._d.move_to_end(key)
            meta = self._meta.get(key)
            if meta is not None:
                meta["hits"] += 1
            return hit[1]

    def peek(self, key):
        """The stored ``(versions, value, nbytes)``, stale or not (None when
        absent)."""
        with self._lock:
            return self._d.get(key)

    def revalidate(self, key, old_versions: tuple, new_versions: tuple) -> bool:
        """Compare-and-set the stored version vector (the caller proved
        every bump between the two disjoint from the entry's range). False
        when a racer replaced or dropped the entry meanwhile."""
        with self._lock:
            hit = self._d.get(key)
            if hit is None or hit[0] != old_versions:
                return False
            self._d[key] = (new_versions, hit[1], hit[2])
            self._d.move_to_end(key)
            return True

    def drop(self, key) -> None:
        """Remove an entry outright (an extension that wrote its mirrors but
        could not commit: it must never be served or extended again)."""
        with self._lock:
            gone = self._d.pop(key, None)
            self._meta.pop(key, None)
        if gone is not None:
            self.ledger.free(gone[2], "drop")

    def note(self, key, outcome: str) -> None:
        """Record an entry's last maintenance outcome."""
        with self._lock:
            meta = self._meta.get(key)
            if meta is not None:
                meta["last_outcome"] = outcome

    def pin(self, key, owner) -> None:
        """Pin ``key`` against eviction on behalf of ``owner``."""
        with self._lock:
            self._pins.setdefault(key, set()).add(owner)

    def unpin(self, key, owner) -> None:
        with self._lock:
            owners = self._pins.get(key)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    self._pins.pop(key, None)

    def put(self, key, versions: tuple, value, nbytes: int) -> None:
        """Store an entry, evicting least recently used unpinned entries
        while the count or byte budget is exceeded; an entry larger than
        the whole budget is not stored."""
        if nbytes > self.max_bytes:
            return
        freed = []
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                freed.append((old[2], "replace"))
            used = sum(e[2] for e in self._d.values())
            while self._d and (len(self._d) >= self.max_entries
                               or used + nbytes > self.max_bytes):
                ek = next((k for k in self._d if k not in self._pins), None)
                if ek is None:
                    break  # only pinned entries left: run over budget
                evicted = self._d.pop(ek)[2]
                used -= evicted
                freed.append((evicted, "evict"))
                self._meta.pop(ek, None)
            self._d[key] = (versions, value, nbytes)
            block = getattr(value, "block", value)
            if isinstance(block, StagedBlock) and block.mgrid_deferred:
                block.grow_hooks.append(lambda b, n, key=key: self._grown(key, b, n))
            prev = self._meta.get(key)
            self._meta[key] = {
                "created": time.time(),
                "hits": prev["hits"] if prev else 0,
                "last_outcome": prev["last_outcome"] if prev else None,
            }
        for n, reason in freed:
            self.ledger.free(n, reason)
        self.ledger.alloc(nbytes)

    def snapshot(self) -> list[dict]:
        """One dict per cached entry: key, bytes, age, hits, last outcome,
        versions, pinned, and the block's series, shape, stage mode and
        grid class."""
        now = time.time()
        with self._lock:
            items = [(k, v, dict(self._meta.get(k) or {}), k in self._pins)
                     for k, v in self._d.items()]
        out = []
        for key, (versions, value, nbytes), meta, pinned in items:
            entry = {
                "key": repr(key),
                "bytes": int(nbytes),
                "age_s": round(now - meta.get("created", now), 3),
                "hits": int(meta.get("hits", 0)),
                "last_outcome": meta.get("last_outcome"),
                "versions": list(versions),
                "pinned": bool(pinned),
            }
            block = getattr(value, "block", None)
            if block is not None:
                entry["series"] = int(getattr(value, "series", 0) or block.n_series)
                entry["shape"] = list(block.vals.shape)
                entry["stage_mode"] = getattr(value, "stage_mode", None)
                entry["grid"] = grid_class(block, build=False)
                entry["device"] = block_device(block)
            out.append(entry)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
