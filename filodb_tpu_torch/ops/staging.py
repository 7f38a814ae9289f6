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

Every block takes the window-stats kernel; the shared-grid classification
of the JAX package is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


@dataclass
class StagedBlock:
    """One staged window block: everything the range kernel needs. The
    arrays are numpy on the host until ``to_device`` moves them."""

    ts: np.ndarray | torch.Tensor  # [S, T] int32 ms offsets from base_ms; TS_PAD in padding
    vals: np.ndarray | torch.Tensor  # [S, T] f32; counters: reset-corrected minus baseline
    lens: np.ndarray | torch.Tensor  # [S] int32 valid sample count per series
    base_ms: int  # absolute ms of offset 0
    baseline: np.ndarray | torch.Tensor  # [S] f32 per-series value offset (else 0)
    n_series: int  # real series count (<= S)
    part_refs: list  # (shard_num, part_id) per real series row
    raw: np.ndarray | torch.Tensor | None = None  # [S, T] f32 raw values (counters only)

    @property
    def shape(self):
        return tuple(self.ts.shape)

    def to_device(self, device) -> "StagedBlock":
        """Move the block's arrays to ``device``; returns self for chaining."""
        def put(a):
            return torch.as_tensor(a).to(device)

        self.ts = put(self.ts)
        self.vals = put(self.vals)
        self.lens = put(self.lens)
        self.baseline = put(self.baseline)
        if self.raw is not None:
            self.raw = put(self.raw)
        return self

    def nbytes(self) -> int:
        arrays = (self.ts, self.vals, self.raw, self.baseline, self.lens)
        return sum(int(a.nbytes) for a in arrays if a is not None)


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
) -> StagedBlock:
    """Build a host StagedBlock from per-series (ts_ms int64, values f64)
    pairs. Three modes: raw values (default), ``counter_corrected``
    (reset-corrected minus the first value, raw values alongside) and
    ``subtract_baseline`` (raw minus the first value, no correction)."""
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
    T = pad_time(maxlen)
    out_ts = np.full((S, T), TS_PAD, dtype=np.int32)
    out_vals = np.zeros((S, T), dtype=np.float32)
    out_raw = np.zeros((S, T), dtype=np.float32) if counter_corrected else None
    lens = np.zeros(S, dtype=np.int32)
    baseline = np.zeros(S, dtype=np.float32)
    for i, (ts, vals) in enumerate(cleaned):
        m = len(ts)
        lens[i] = m
        if m == 0:
            continue
        out_ts[i, :m] = (ts - base_ms).astype(np.int32)
        if counter_corrected:
            b = np.float64(vals[0])
            baseline[i] = b
            out_vals[i, :m] = (counter_correct(vals) - b).astype(np.float32)
            # raw rides along unshifted: it only feeds the zero-crossing cap,
            # which engages only for raw values near zero, where f32 is exact
            out_raw[i, :m] = vals.astype(np.float32)
        elif subtract_baseline:
            b = np.float64(vals[0])
            baseline[i] = b
            out_vals[i, :m] = (vals.astype(np.float64) - b).astype(np.float32)
        else:
            out_vals[i, :m] = vals.astype(np.float32)
    return StagedBlock(out_ts, out_vals, lens, base_ms, baseline, n,
                       part_refs or [], raw=out_raw)


def block_from_arrays(ts, vals, lens, base_ms: int, baseline, n_series: int,
                      raw=None, device="cuda") -> StagedBlock:
    """A device block from plain arrays (numpy or anything ``np.asarray``
    takes) — how a block staged elsewhere, such as a JAX ``StagedBlock``,
    is carried into the port."""
    ts = np.asarray(ts, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    lens = np.asarray(lens, dtype=np.int32)
    if ts.ndim != 2 or vals.shape != ts.shape or lens.shape != (ts.shape[0],):
        raise ValueError(f"block shapes disagree: ts {ts.shape}, vals {vals.shape}, lens {lens.shape}")
    if raw is not None:
        raw = np.asarray(raw, dtype=np.float32)
        if raw.shape != ts.shape:
            raise ValueError(f"raw shape {raw.shape} != ts shape {ts.shape}")
    block = StagedBlock(
        ts, vals, lens, int(base_ms), np.asarray(baseline, dtype=np.float32),
        int(n_series), [], raw=raw,
    )
    return block.to_device(device)


def stage_from_shard(shard, part_ids, column: str, start_ms: int, end_ms: int,
                     mode: str) -> StagedBlock:
    """Gather [start_ms, end_ms] samples for part_ids from a shard and stage
    them on the host. ``mode`` is ``"corrected"``, ``"shifted"`` or
    ``"raw"`` (see plans._stage_mode_for_function)."""
    series, refs = [], []
    for pid in part_ids:
        part = shard.partition(int(pid))
        series.append(part.samples_in_range(start_ms, end_ms, column))
        refs.append((shard.shard_num, int(pid)))
    return stage_series(
        series, start_ms, refs,
        counter_corrected=mode == "corrected",
        subtract_baseline=mode == "shifted",
    )


def concat_blocks(blocks) -> StagedBlock:
    """Row-concatenate host blocks into one padded superblock exactly:
    corrected values, raw sidecars, baselines and part refs carry over.
    All blocks must share base_ms."""
    real = [b for b in blocks if b.n_series > 0] or list(blocks[:1])
    if not real or len({b.base_ms for b in real}) != 1:
        raise ValueError("concat_blocks needs blocks that share one base_ms")
    T = max(b.ts.shape[1] for b in real)
    S = sum(b.n_series for b in real)
    Sp = pad_series(S)
    ts = np.full((Sp, T), TS_PAD, np.int32)
    vals = np.zeros((Sp, T), np.float32)
    raw = np.zeros((Sp, T), np.float32) if any(b.raw is not None for b in real) else None
    lens = np.zeros(Sp, np.int32)
    baseline = np.zeros(Sp, np.float32)
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
    return StagedBlock(ts, vals, lens, real[0].base_ms, baseline, S, part_refs, raw=raw)
