"""Histogram bucket schemes (counterpart of ``filodb_tpu/core/histograms.py``;
reference L0 format/vectors/Histogram.scala:609-899 -- Geometric, Custom,
Base2Exponential schemes).

A histogram sample is a vector of cumulative bucket counts aligned to a
bucket scheme; the top bucket is +Inf. Native histograms stage as
``[S, T, B]`` blocks, and ``histogram_quantile`` interpolates over the
bucket axis (``ops/hist_kernels.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BucketScheme:
    """Bucket upper bounds (``le`` values), last = +inf."""

    les: tuple[float, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.les)

    def bounds(self) -> np.ndarray:
        return np.asarray(self.les, dtype=np.float64)


def custom_buckets(les) -> BucketScheme:
    les = tuple(float(x) for x in les)
    if les[-1] != np.inf:
        les = les + (np.inf,)
    return BucketScheme(les)


def geometric_buckets(first: float, multiplier: float, num: int) -> BucketScheme:
    """reference GeometricBuckets (Histogram.scala:609)."""
    les = tuple(first * multiplier**i for i in range(num)) + (np.inf,)
    return BucketScheme(les)


def base2_exp_buckets(scale: int, start_index: int, num: int) -> BucketScheme:
    """OTel base-2 exponential scheme (reference Base2ExpHistogramBuckets,
    Histogram.scala:684): bucket i upper bound = 2^((start+i+1) * 2^-scale),
    with a zero bucket first."""
    base = 2.0 ** (2.0**-scale)
    les = (0.0,) + tuple(base ** (start_index + i + 1) for i in range(num)) + (np.inf,)
    return BucketScheme(les)


# the reference's default Prometheus-style scheme (12 buckets with +Inf)
PROM_DEFAULT = custom_buckets(
    [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]
)


# -- bucket-scheme unification (heterogeneous schemes across shards) --------
#
# Per-shard histogram blocks are remapped onto a common scheme before they
# concatenate into one superblock (reference Histogram.scala
# HistogramWithBuckets add/convert), on [.., B]-shaped cumulative counts.

_LE_TOL = 1e-10  # bound-match tolerance of every scheme comparison


def same_scheme(a, b) -> bool:
    """True when two ``le`` bound vectors describe the same bucket scheme:
    equal length, every bound within ``_LE_TOL`` (equal +Inf top buckets
    match). The one equality rule of every unification site."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if len(a) != len(b):
        return False
    with np.errstate(invalid="ignore"):
        diff = np.abs(a - b)  # inf - inf -> nan: equal infinite tops match
    return not (diff > _LE_TOL).any()


def union_les(les_list) -> np.ndarray:
    """Union bucket scheme of several ``le`` bound vectors: sorted unique
    finite bounds (within ``_LE_TOL``) plus the +Inf top bucket every
    scheme carries."""
    bounds: list[float] = []
    for les in les_list:
        for x in np.asarray(les, dtype=np.float64):
            if np.isinf(x):
                continue
            if not any(abs(x - b) < _LE_TOL for b in bounds):
                bounds.append(float(x))
    return np.asarray(sorted(bounds) + [np.inf], dtype=np.float64)


def bucket_mapping(src_les, dst_les) -> np.ndarray:
    """For each dst bound, the index of the matching src bound, or the
    largest src bound strictly below it (-1 when none). Cumulative counts
    at a bound a scheme doesn't carry take the count of the nearest lower
    bound it does (0 below the first): the exact lower-bound completion of
    a cumulative distribution, monotone by construction."""
    src = np.asarray(src_les, dtype=np.float64)
    out = np.empty(len(dst_les), dtype=np.int64)
    for i, x in enumerate(np.asarray(dst_les, dtype=np.float64)):
        hit = np.nonzero(
            np.isclose(src, x, rtol=0.0, atol=_LE_TOL)
            | (np.isinf(src) & np.isinf([x] * len(src)))
        )[0]
        if len(hit):
            out[i] = hit[0]
        else:
            below = np.nonzero(src < x - _LE_TOL)[0]
            out[i] = below[-1] if len(below) else -1
    return out


def unify_schemes(arrays, les_list):
    """Remap several [..., B_i]-shaped cumulative-count arrays onto the
    union of their bucket schemes (``union_les`` + ``remap_buckets``).
    Returns (arrays', union, changed); arrays already on the union scheme
    pass through as the same objects, and changed=False means every one
    did."""
    les64 = [np.asarray(l, dtype=np.float64) for l in les_list]
    union = union_les(les64)
    out = [remap_buckets(a, l, union) for a, l in zip(arrays, les64)]
    changed = any(o is not a for o, a in zip(out, arrays))
    return out, union, changed


def remap_buckets(arr: np.ndarray, src_les, dst_les) -> np.ndarray:
    """Remap an [..., B_src] cumulative-count array onto ``dst_les``:
    matching bounds copy through, missing bounds take the nearest lower
    bound's count (0 when below the scheme's first bound). Exact identity
    (the same object) when the schemes already agree."""
    src = np.asarray(src_les, dtype=np.float64)
    dst = np.asarray(dst_les, dtype=np.float64)
    if len(src) == len(dst) and np.allclose(src[:-1], dst[:-1], rtol=0.0, atol=_LE_TOL):
        return arr
    m = bucket_mapping(src, dst)
    a = np.asarray(arr)
    out = np.zeros(a.shape[:-1] + (len(dst),), dtype=a.dtype)
    have = m >= 0
    out[..., have] = a[..., m[have]]
    return out
