"""Result model (counterpart of ``filodb_tpu/query/rangevector.py``;
reference RangeVector.scala:129).

Results travel as grids: a batch of series sharing one step grid with a
dense ``[S, J]`` value matrix (NaN = absent), and for native histograms
the ``[S, J, B]`` bucket values with their bounds. ``values`` and ``hist``
may be torch tensors on the card; they convert to numpy at the edge. A
tree leaf's staged selection travels as a ``RawGrid`` until its
``PeriodicSamplesMapper`` turns it into a grid. A scalar plan's answer is
a ``ScalarResult``: one f64 value per step, on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


@dataclass
class Grid:
    """A batch of series on a shared step grid."""

    labels: list[dict]  # [S] per-series label sets
    start_ms: int
    step_ms: int
    num_steps: int
    values: Any  # [S, J] tensor or numpy; J >= num_steps (padding allowed)
    hist: Any | None = None  # [S, J, B] bucket values of a histogram result
    les: np.ndarray | None = None  # [B] bucket bounds of ``hist``
    # the staged block a tree leaf's grid was computed from (its row
    # order): the map phases memoize their groupings on it
    source: Any = None

    @property
    def n_series(self) -> int:
        return len(self.labels)

    def step_times_ms(self) -> np.ndarray:
        return self.start_ms + np.arange(self.num_steps, dtype=np.int64) * self.step_ms

    def values_np(self) -> np.ndarray:
        """[S, num_steps] numpy array (fetched from the card if needed)."""
        v = self.values
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return v[: self.n_series, : self.num_steps]

    def hist_np(self) -> np.ndarray | None:
        """[S, num_steps, B] numpy array of a histogram result, else None. A
        tensor's real rows and steps are made contiguous where they lie
        (on the card for a leaf's step-major view) and fetched in one
        copy."""
        if self.hist is None:
            return None
        h = self.hist[: self.n_series, : self.num_steps]
        return h.detach().contiguous().cpu().numpy() if isinstance(h, torch.Tensor) else (
            np.asarray(h))


@dataclass
class RawGrid:
    """Pre-periodic staged raw samples of one schema (reference
    RawDataRangeVector): the staged block on the query's device."""

    block: Any  # ops.staging.StagedBlock
    labels: list[dict]
    schema_name: str
    value_column: str
    is_counter: bool
    is_delta: bool
    is_histogram: bool
    les: np.ndarray | None = None


@dataclass
class ScalarResult:
    """A scalar per step (the PromQL scalar type), on the host."""

    start_ms: int
    step_ms: int
    num_steps: int
    values: np.ndarray  # [J]


@dataclass
class QueryStats:
    """reference QuerySession.queryStats (ExecPlan.scala:430)."""

    series_scanned: int = 0
    samples_scanned: int = 0
    bytes_staged: int = 0
    # the JAX package's host CPU and device dispatch nanoseconds; the port
    # does not measure them (0)
    cpu_ns: int = 0
    kernel_ns: int = 0
    # staging and superblock cache events of the query's staging path: hits
    # (served cached), misses (a full stage or build), extends (an in-place
    # append repair or superblock extension)
    cache_hits: int = 0
    cache_misses: int = 0
    cache_extends: int = 0
    # the rungs that served the query's range functions: variant -> launches
    # (a fused aggregate one, a tree leaf one per shard; ``host`` for the
    # host's timestamp)
    rungs: dict = field(default_factory=dict)

    def bump(self, **deltas: int) -> None:
        for k, v in deltas.items():
            setattr(self, k, getattr(self, k) + v)

    def note_rung(self, variant: str) -> None:
        """Count one range-function dispatch served by ``variant``."""
        self.rungs[variant] = self.rungs.get(variant, 0) + 1


@dataclass
class QueryResult:
    """Exec output: a list of grids, a scalar, the raw samples of a
    top-level range selector (``raw``: one (labels, ts int64 ms, values)
    per series) or a metadata answer (``metadata``: label values or names,
    series label sets, cardinality or chunk records)."""

    grids: list[Grid] = field(default_factory=list)
    stats: QueryStats = field(default_factory=QueryStats)
    result_type: str = "matrix"  # matrix | vector | scalar | metadata
    raw_grids: list[RawGrid] = field(default_factory=list)  # a tree leaf's staged selection
    scalar: ScalarResult | None = None
    raw: list[tuple[dict, np.ndarray, np.ndarray]] | None = None
    metadata: list | None = None
    # the partial-results protocol of the JAX package: warnings for lost
    # children and ``partial``; every shard is local to the port, so these
    # stay empty and False
    warnings: list[dict] = field(default_factory=list)
    partial: bool = False
    # the query's root span (``metrics.Span``) and its host phases in
    # seconds (``plan``, ``execute``), set by ``QueryEngine``
    trace: Any | None = None
    phases: dict = field(default_factory=dict)

    def all_series(self):
        """Iterate (labels, ts_ms[], values[]) dropping NaN points."""
        for g in self.grids:
            vals = g.values_np()
            times = g.step_times_ms()
            for i, lbls in enumerate(g.labels):
                row = vals[i]
                m = ~np.isnan(row)
                if m.any():
                    yield lbls, times[m], row[m]
