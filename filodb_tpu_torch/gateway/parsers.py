"""Ingest line-protocol parsers of the port (counterpart of
``filodb_tpu/gateway/parsers.py``; reference L7 gateway/:
InfluxProtocolParser.scala / InputRecord.scala:15 PrometheusInputRecord --
Influx line protocol and Prometheus text exposition -> ingestion records).

These are the JAX package's pure-Python tier. Its native scanner
(``filodb_tpu/native``, a C++ host library) and the TCP gateway are not
ported (ROADMAP A10).
"""

from __future__ import annotations

import re
from typing import Iterable

import numpy as np

from ..core.records import RecordBatch
from ..core.schemas import GAUGE, METRIC_TAG, PROM_COUNTER, Schema


def _unescape(s: str) -> str:
    return s.replace("\\,", ",").replace("\\ ", " ").replace("\\=", "=").replace('\\"', '"')


_INFLUX_SPLIT = re.compile(r"(?<!\\) ")
_COMMA_SPLIT = re.compile(r"(?<!\\),")


def parse_influx_line(line: str):
    """One Influx line: measurement[,tag=v...] field=v[,field=v...] [ts_ns].

    Yields (metric, tags, ts_ms, value) per numeric field; measurement
    becomes the metric prefix for non-'value' fields (reference
    InfluxProtocolParser field handling).
    """
    line = line.strip()
    if not line or line.startswith("#"):
        return
    parts = _INFLUX_SPLIT.split(line)
    if len(parts) < 2:
        raise ValueError(f"bad influx line: {line!r}")
    key_part, field_part = parts[0], parts[1]
    ts_ms = int(parts[2]) // 1_000_000 if len(parts) > 2 else None
    key_items = _COMMA_SPLIT.split(key_part)
    measurement = _unescape(key_items[0])
    tags = {}
    for item in key_items[1:]:
        k, _, v = item.partition("=")
        tags[_unescape(k)] = _unescape(v)
    for fv in _COMMA_SPLIT.split(field_part):
        k, _, v = fv.partition("=")
        k = _unescape(k)
        v = v.strip()
        if v.endswith("i"):
            val = float(v[:-1])
        elif v in ("t", "T", "true", "True"):
            val = 1.0
        elif v in ("f", "F", "false", "False"):
            val = 0.0
        elif v.startswith('"'):
            continue  # string fields are not time series values
        else:
            val = float(v)
        metric = measurement if k == "value" else f"{measurement}_{k}"
        yield metric, dict(tags), ts_ms, val


_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+))?$"
)
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


_EXEMPLAR = re.compile(
    r"^\{(?P<labels>.*)\}\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+(?:\.\d+)?))?$"
)


def _parse_labels(s: str) -> dict:
    return {
        lm.group(1): lm.group(2).encode().decode("unicode_escape")
        for lm in _PROM_LABEL.finditer(s)
    }


def _parse_sample_line(line: str):
    """One sample line -> (name, tags, ts_ms|None, value, exemplar|None).

    The OpenMetrics exemplar suffix `# {labels} value [ts]` is accepted ONLY
    when both halves parse on their own; otherwise the whole line must match
    (so legal label values containing ' # {' keep working, and a greedy
    label match can never swallow a real exemplar)."""
    exemplar = None
    m = None
    idx = line.rfind(" # {")
    if idx != -1:
        em = _EXEMPLAR.match(line[idx + 3:])
        m2 = _PROM_LINE.match(line[:idx].rstrip())
        if em and m2:
            ex_ts = em.group("ts")
            exemplar = (
                _parse_labels(em.group("labels")),
                float(em.group("value")),
                int(float(ex_ts) * 1000) if ex_ts else None,
            )
            m = m2
    if m is None:
        m = _PROM_LINE.match(line)
    if not m:
        raise ValueError(f"bad prometheus line: {line!r}")
    name = m.group("name")
    tags = _parse_labels(m.group("labels")) if m.group("labels") else {}
    vs = m.group("value")
    val = float("nan") if vs in ("NaN", "nan") else float(vs)
    ts_ms = int(m.group("ts")) if m.group("ts") else None
    return name, tags, ts_ms, val, exemplar


def _series_type(name: str, types: dict[str, str]) -> str:
    """Resolve a sample's type from the TYPE table, understanding family
    suffixes: a ``# TYPE m histogram|summary`` family exposes ``m_bucket``/
    ``m_count``/``m_sum`` series, which are cumulative — counter semantics
    (Prometheus treats them so for rate()); OpenMetrics counters declare the
    family WITHOUT the ``_total`` their samples carry."""
    t = types.get(name)
    if t is not None:
        return t
    for suffix in ("_bucket", "_count", "_sum"):
        if name.endswith(suffix):
            if types.get(name[: -len(suffix)]) in ("histogram", "summary"):
                return "counter"
    if name.endswith("_total") and types.get(name[:-6]) == "counter":
        return "counter"
    return "untyped"


def parse_prom_text(text: str, with_exemplars: bool = False):
    """Prometheus exposition format -> (metric, tags, ts_ms, value, type)
    tuples; with ``with_exemplars`` a sixth element carries the OpenMetrics
    exemplar ``(labels, value, ts_ms|None)`` or None. TYPE comments steer
    counter/gauge schema choice."""
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE"):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        name, tags, ts_ms, val, exemplar = _parse_sample_line(line)
        if with_exemplars:
            yield name, tags, ts_ms, val, _series_type(name, types), exemplar
        else:
            yield name, tags, ts_ms, val, _series_type(name, types)


def influx_to_batch(lines: "Iterable[str] | str", default_ts_ms: int,
                    ws="default", ns="default") -> RecordBatch:
    """Influx line protocol -> one gauge RecordBatch."""
    if isinstance(lines, str):
        lines = lines.splitlines()
    tags_list, ts, vals = [], [], []
    for line in lines:
        for metric, tags, t, v in parse_influx_line(line) or ():
            full = dict(tags)
            full[METRIC_TAG] = metric
            full.setdefault("_ws_", ws)
            full.setdefault("_ns_", ns)
            tags_list.append(full)
            ts.append(t if t is not None else default_ts_ms)
            vals.append(v)
    return RecordBatch(
        GAUGE, np.asarray(ts, dtype=np.int64), {"value": np.asarray(vals)}, tags_list
    )


def prom_text_to_batches(text: str, default_ts_ms: int, ws="default", ns="default") -> list[RecordBatch]:
    """Split by schema: counters -> prom-counter, rest -> gauge."""
    return prom_text_to_batches_and_exemplars(text, default_ts_ms, ws, ns)[0]


def _assemble_batches(gauges, counters) -> list[RecordBatch]:
    out = []
    for (tags_list, rows), schema, col in (
        (gauges, GAUGE, "value"),
        (counters, PROM_COUNTER, "count"),
    ):
        if tags_list:
            ts = np.asarray([r[0] for r in rows], dtype=np.int64)
            vals = np.asarray([r[1] for r in rows])
            out.append(RecordBatch(schema, ts, {col: vals}, tags_list))
    return out


def prom_text_to_batches_and_exemplars(
    text: str, default_ts_ms: int, ws="default", ns="default"
) -> tuple[list[RecordBatch], list]:
    """One parse of the exposition payload yielding both the schema-split
    sample batches and the OpenMetrics exemplars as
    (full_tags, ts_ms, exemplar_value, exemplar_labels)."""
    gauges, counters = ([], []), ([], [])
    exemplars = []
    for name, tags, t, v, typ, ex in parse_prom_text(text, with_exemplars=True):
        full = dict(tags)
        full[METRIC_TAG] = name
        full.setdefault("_ws_", ws)
        full.setdefault("_ns_", ns)
        bucket = counters if typ == "counter" else gauges
        bucket[0].append(full)
        bucket[1].append((t if t is not None else default_ts_ms, v))
        if ex is not None:
            ex_labels, ex_val, ex_ts = ex
            exemplars.append(
                (full, ex_ts if ex_ts is not None else (t if t is not None else default_ts_ms),
                 ex_val, ex_labels)
            )
    return _assemble_batches(gauges, counters), exemplars
