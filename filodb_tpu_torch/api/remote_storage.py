"""Prometheus remote write and read of the port (counterpart of
``filodb_tpu/api/remote_storage.py``; reference L6 remote-storage.proto).

Bodies are snappy block-compressed protobuf (``api/snappy.py``) in
prompb's messages, encoded and decoded by the port's own codec
(``api/prompb.py``), so no protobuf library is needed.
"""

from __future__ import annotations

import numpy as np

from ..core.filters import ColumnFilter
from ..core.records import RecordBatch
from ..core.schemas import GAUGE, METRIC_TAG
from . import prompb, snappy


def parse_write_request(body: bytes) -> list[RecordBatch]:
    """snappy+proto WriteRequest -> RecordBatches (gauge schema; Prometheus
    remote write carries no type info)."""
    tags_list, ts, vals = [], [], []
    for series in prompb.decode_write_request(snappy.decompress(body)):
        tags = {METRIC_TAG if name == "__name__" else name: value
                for name, value in series.labels}
        for v, t in series.samples:
            tags_list.append(tags)
            ts.append(t)
            vals.append(v)
    if not tags_list:
        return []
    return [
        RecordBatch(
            GAUGE,
            np.asarray(ts, dtype=np.int64),
            {"value": np.asarray(vals, dtype=np.float64)},
            tags_list,
        )
    ]


_MATCHER_OPS = {0: "=", 1: "!=", 2: "=~", 3: "!~"}


def handle_read_request(body: bytes, memstore, dataset: str) -> bytes:
    """snappy+proto ReadRequest -> snappy+proto ReadResponse with the raw
    samples of each query's series (NaN samples left out)."""
    results = []
    for q in prompb.decode_read_request(snappy.decompress(body)):
        filters = [ColumnFilter(METRIC_TAG if m.name == "__name__" else m.name,
                                _MATCHER_OPS[int(m.type)], m.value) for m in q.matchers]
        result = []
        for shard in memstore.shards(dataset):
            for pid in shard.lookup_partitions(filters, q.start_timestamp_ms,
                                               q.end_timestamp_ms):
                part = shard.partition(int(pid))
                try:
                    t, v = part.samples_in_range(q.start_timestamp_ms, q.end_timestamp_ms,
                                                 part.schema.value_column)
                except KeyError:
                    continue
                if v.ndim != 1 or not len(t):
                    continue
                keep = ~np.isnan(v)
                result.append(prompb.TimeSeries(
                    [("__name__" if k == METRIC_TAG else k, val)
                     for k, val in sorted(part.tags.items())],
                    list(zip(v[keep].astype(float).tolist(), t[keep].astype(int).tolist()))))
        results.append(result)
    return snappy.compress(prompb.encode_read_response(results))
