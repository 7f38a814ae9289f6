"""Memstore facade: per-dataset shard map (counterpart of
``filodb_tpu/memstore/memstore.py``; reference L2: TimeSeriesMemStore.scala:26).
"""

from __future__ import annotations

from typing import Sequence

from ..core.schemas import Dataset
from .shard import StoreConfig, TimeSeriesShard


class TimeSeriesMemStore:
    def __init__(self, store_config: StoreConfig | None = None):
        self._datasets: dict[str, dict[int, TimeSeriesShard]] = {}
        self._dataset_meta: dict[str, Dataset] = {}
        self._total_shards: dict[str, int] = {}
        self.store_config = store_config or StoreConfig()

    def setup(self, dataset: Dataset, shard_nums: Sequence[int],
              total_shards: int | None = None) -> None:
        """``total_shards`` is the cluster's shard count (the routing
        modulus); it is inferred from the owned set when not given."""
        shards = self._datasets.setdefault(dataset.name, {})
        self._dataset_meta[dataset.name] = dataset
        nums = list(shard_nums)
        self._total_shards[dataset.name] = max(
            total_shards or 0, (max(nums) + 1) if nums else 0,
            self._total_shards.get(dataset.name, 0),
        )
        for s in nums:
            if s not in shards:
                shards[s] = TimeSeriesShard(dataset.name, s, self.store_config)

    def total_shards(self, dataset: str) -> int:
        return self._total_shards[dataset]

    def shard(self, dataset: str, shard_num: int) -> TimeSeriesShard:
        return self._datasets[dataset][shard_num]

    def shard_nums(self, dataset: str) -> list[int]:
        return sorted(self._datasets.get(dataset, {}).keys())

    def dataset(self, name: str) -> Dataset:
        return self._dataset_meta[name]
