"""Ingestion records (counterpart of ``filodb_tpu/core/records.py``;
reference L1: binaryrecord2/RecordBuilder.scala).

The port keeps the grouped form only: a ``SeriesBatch`` is one series'
time-ordered samples, the unit ``TimeSeriesShard.ingest_series`` consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from .schemas import Schema, canonical_partkey


@dataclass
class SeriesBatch:
    """Samples for a single series (one partition key), time-ordered."""

    schema: Schema
    tags: Mapping[str, str]
    timestamps: np.ndarray
    values: dict[str, np.ndarray]

    @property
    def partkey(self) -> bytes:
        return canonical_partkey(self.tags)
