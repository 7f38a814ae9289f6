"""Result model (counterpart of ``filodb_tpu/query/rangevector.py``;
reference RangeVector.scala:129).

Results travel as grids: a batch of series sharing one step grid with a
dense ``[S, J]`` value matrix (NaN = absent). ``values`` may be a torch
tensor on the card; it converts to numpy at the edge.
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

    @property
    def n_series(self) -> int:
        return len(self.labels)

    def values_np(self) -> np.ndarray:
        """[S, num_steps] numpy array (fetched from the card if needed)."""
        v = self.values
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return v[: self.n_series, : self.num_steps]


@dataclass
class QueryStats:
    """reference QuerySession.queryStats (ExecPlan.scala:430)."""

    series_scanned: int = 0
    samples_scanned: int = 0
    bytes_staged: int = 0

    def bump(self, **deltas: int) -> None:
        for k, v in deltas.items():
            setattr(self, k, getattr(self, k) + v)


@dataclass
class QueryResult:
    """Exec output: a list of grids."""

    grids: list[Grid] = field(default_factory=list)
    stats: QueryStats = field(default_factory=QueryStats)
    result_type: str = "matrix"  # matrix | vector
