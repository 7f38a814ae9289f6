"""Memstore facade: per-dataset shard map (counterpart of
``filodb_tpu/memstore/memstore.py``; reference L2: TimeSeriesMemStore.scala:26),
with the metadata queries and the exemplars over every shard of a dataset.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from typing import Iterable, Mapping, Sequence

from ..core.records import RecordBatch
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
                shards[s].evict_hooks.append(self._drop_stale_superblocks)

    def _drop_stale_superblocks(self, shard) -> None:
        """An eviction changed ``shard``'s resident data: drop the cached
        superblocks that hold its series, freeing their device memory (a
        later query of theirs restages anyway)."""
        cache = getattr(self, "_superblock_cache", None)
        if cache is not None:
            cache.drop_where(lambda key: key[0] == shard.dataset and shard.shard_num in key[1])

    def total_shards(self, dataset: str) -> int:
        return self._total_shards[dataset]

    def shard(self, dataset: str, shard_num: int) -> TimeSeriesShard:
        return self._datasets[dataset][shard_num]

    def shard_nums(self, dataset: str) -> list[int]:
        return sorted(self._datasets.get(dataset, {}).keys())

    def shards(self, dataset: str) -> list[TimeSeriesShard]:
        return list(self._datasets.get(dataset, {}).values())

    def dataset(self, name: str) -> Dataset:
        return self._dataset_meta[name]

    # -- metadata ------------------------------------------------------------

    def label_values(self, dataset: str, filters, label: str, start_ts: int, end_ts: int,
                     limit=None) -> list[str]:
        vals: set[str] = set()
        for sh in self.shards(dataset):
            vals.update(sh.label_values(filters, label, start_ts, end_ts, limit))
        out = sorted(vals)
        return out[:limit] if limit else out

    def label_names(self, dataset: str, filters, start_ts: int, end_ts: int) -> list[str]:
        names: set[str] = set()
        for sh in self.shards(dataset):
            names.update(sh.label_names(filters, start_ts, end_ts))
        return sorted(names)

    def series(self, dataset: str, filters, start_ts: int, end_ts: int,
               limit=None) -> list[Mapping[str, str]]:
        out: list[Mapping[str, str]] = []
        for sh in self.shards(dataset):
            out.extend(sh.partkeys(filters, start_ts, end_ts, limit))
            if limit and len(out) >= limit:
                return out[:limit]
        return out

    def metric_metadata(self, dataset: str) -> dict[str, list[dict]]:
        """The Prometheus /api/v1/metadata payload from the live schemas:
        one entry per metric, its type (counter/gauge/histogram/unknown)
        that of a representative series' schema (the JAX package's rule)."""
        from ..core.filters import equals
        from ..core.schemas import METRIC_TAG

        out: dict[str, list[dict]] = {}
        for sh in self.shards(dataset):
            for metric in sh.label_values([], METRIC_TAG, 0, 2**62):
                if metric in out:
                    continue
                pids = sh.lookup_partitions([equals(METRIC_TAG, metric)], 0, 2**62, limit=1)
                if not len(pids):
                    continue
                name = sh.partition(int(pids[0])).schema.name
                if "histogram" in name:
                    mtype = "histogram"
                elif "counter" in name:
                    mtype = "counter"
                elif name == "untyped":
                    mtype = "unknown"
                else:
                    mtype = "gauge"
                out[metric] = [{"type": mtype, "help": "", "unit": ""}]
        return dict(sorted(out.items()))

    # -- ingest --------------------------------------------------------------

    def ingest(self, dataset: str, shard_num: int, batch: RecordBatch, offset: int = -1) -> int:
        return self.shard(dataset, shard_num).ingest(batch, offset)

    def ingest_routed(self, dataset: str, batch: RecordBatch, spread: int) -> int:
        """Route a mixed batch to owned shards by shard-key hash (gateway
        path). The batch commits atomically across its shards: every
        destination shard's lock is held, in shard order, until the last
        shard has ingested, so a reader holding the member shards' locks in
        the same order (``member_locks``) sees all of the batch or none."""
        shards = self._datasets[dataset]
        options = self._dataset_meta[dataset].options
        subs = batch.shard_split(spread, self.total_shards(dataset), options)
        owned = sorted(s for s in subs if s in shards)
        n = 0
        with member_locks(shards[s] for s in owned):
            for s in owned:
                n += shards[s].ingest(subs[s])
        return n

    # -- exemplars (OpenMetrics) ---------------------------------------------

    def add_exemplars(self, dataset: str, spread: int, items) -> int:
        """Attach exemplars, items ``(tags, ts_ms, value, exemplar_labels)``,
        to their series; a series that does not exist is skipped (exemplars
        ride beside samples and never create a series)."""
        from ..core.schemas import canonical_partkey, shard_for

        shards = self._datasets[dataset]
        options = self._dataset_meta[dataset].options
        num_shards = self.total_shards(dataset)
        n = 0
        for tags, ts_ms, value, ex_labels in items:
            sh = shards.get(shard_for(tags, spread, num_shards, options))
            if sh is not None and sh.add_exemplar(canonical_partkey(tags), ts_ms, value,
                                                  ex_labels):
                n += 1
        return n

    def query_exemplars(self, dataset: str, filters, start_ms: int, end_ms: int) -> list[dict]:
        """The Prometheus /api/v1/query_exemplars shape: for each matching
        series, its exemplars within [start, end]."""
        out = []
        for sh in self.shards(dataset):
            for pid in sh.lookup_partitions(filters, start_ms, end_ms):
                part = sh.partition(int(pid))
                exs = [{"labels": lbls, "value": f"{val:g}", "timestamp": ts / 1000.0}
                       for ts, val, lbls in part.exemplars if start_ms <= ts <= end_ms]
                if exs:
                    out.append({"seriesLabels": dict(part.tags), "exemplars": exs})
        return out


@contextmanager
def member_locks(shards: Iterable):
    """Hold the locks of ``shards``, taken in shard order (the order
    ``ingest_routed`` takes them, so the two never deadlock)."""
    with ExitStack() as stack:
        for shard in sorted(shards, key=lambda s: s.shard_num):
            stack.enter_context(shard._lock)
        yield
