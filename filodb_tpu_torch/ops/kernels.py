"""Range-query grid parameters (counterpart of the host-side part of
``filodb_tpu/ops/kernels.py``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RangeParams:
    """Output grid + window spec."""

    start_ms: int  # absolute ms of first output step
    step_ms: int
    num_steps: int
    window_ms: int


def pad_steps(j: int) -> int:
    return max(64, ((j + 63) // 64) * 64)
