"""Prometheus HTTP API JSON rendering of the port (counterpart of
``filodb_tpu/api/promjson.py``; reference L6 query/PrometheusModel.scala --
result types matrix/vector/scalar, success/error envelopes, label
normalization).

The port renders with the JAX package's numpy tier (``_rows_numpy``),
byte for byte: the native renderer of ``filodb_tpu/native`` is a C++ host
library the port has not got. A result grid's values may be torch tensors
on the card: ``_grid_blocks`` fetches them block by block on a helper
thread while the previous block is encoded."""

from __future__ import annotations

import json
import math
from typing import Any

import numpy as np
import torch

from ..core.schemas import METRIC_TAG
from ..query.rangevector import QueryResult


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _fmt_val(v):
    """Scalar samples format as Prometheus value strings; 2-D (histogram
    bucket-row) samples as a list of them."""
    if np.ndim(v) == 0:
        return _fmt(float(v))
    return [_fmt(float(x)) for x in v]


def _labels_out(labels: dict) -> dict:
    out = {}
    for k, v in labels.items():
        if k == METRIC_TAG:
            out["__name__"] = v
        elif not k.startswith("__comp__"):
            out[k] = v
    return out


def render_matrix(res: QueryResult) -> dict:
    data = []
    if res.raw is not None:
        for labels, ts, vals in res.raw:
            keep = ~np.isnan(vals) if vals.ndim == 1 else np.ones(len(ts), bool)
            data.append(
                {
                    "metric": _labels_out(labels),
                    "values": [[t / 1000.0, _fmt_val(v)] for t, v in zip(ts[keep], vals[keep])],
                }
            )
    for labels, ts, vals in res.all_series():
        data.append(
            {
                "metric": _labels_out(labels),
                "values": [[t / 1000.0, _fmt(v)] for t, v in zip(ts, vals)],
            }
        )
    return {"resultType": "matrix", "result": data}


def render_vector(res: QueryResult, time_s: float) -> dict:
    data = []
    for labels, ts, vals in res.all_series():
        if len(vals):
            data.append(
                {"metric": _labels_out(labels), "value": [time_s, _fmt(vals[-1])]}
            )
    return {"resultType": "vector", "result": data}


def render_scalar(res: QueryResult, time_s: float) -> dict:
    v = float("nan")
    if res.scalar is not None and len(res.scalar.values):
        v = float(res.scalar.values[-1])
    return {"resultType": "scalar", "result": [time_s, _fmt(v)]}


def _ts3(t: float) -> str:
    """Fixed 3-decimal seconds (Prometheus' millisecond convention),
    byte-identical to the native renderer's llround-based form: half-away
    rounding, and negatives render as sign + magnitude of the truncating
    div/mod (t=-0.5 -> "-0.500", never "-1.500")."""
    ms = int(math.floor(abs(t) * 1000.0 + 0.5))
    sign = "-" if (t < 0 and ms > 0) else ""
    return f"{sign}{ms // 1000}.{ms % 1000:03d}"


def _ts_decorated(ts_s: np.ndarray) -> np.ndarray:
    """Per-step decorated timestamp strings ``"],[<ts3>,"`` — the inter-sample
    glue of a values fragment. Built once per grid and reused across every
    series row (the numpy fast path's main saving at high series counts)."""
    return np.array(['"],[' + _ts3(float(t)) + ',"' for t in ts_s], dtype=object)


def _rows_numpy(tdec: np.ndarray, vals: np.ndarray) -> list[bytes]:
    """Vectorized fragment assembly for a [G,J] float64 matrix: one bulk
    ``json.dumps`` call per row formats every finite value at C speed (the
    json encoder uses float.__repr__, so the digits are byte-identical to
    ``_fmt``), then timestamp/value strings interleave via strided slice
    assignment instead of a per-sample Python loop. ~5x the per-sample
    f-string path; the native renderer (promrender.cpp) is faster still."""
    out = []
    nan = np.isnan(vals)
    for i in range(len(vals)):
        row = vals[i]
        if nan[i].any():
            row = row[~nan[i]]
        k = len(row)
        if k == 0:
            out.append(b"[]")
            continue
        vs = np.array(
            json.dumps(row.tolist(), separators=(",", ":"))[1:-1].split(","),
            dtype=object,
        )
        inf = np.isinf(row)
        if inf.any():  # json spells them Infinity/-Infinity; Prometheus +Inf/-Inf
            vs[inf & (row > 0)] = "+Inf"
            vs[inf & (row < 0)] = "-Inf"
        parts = np.empty(2 * k, dtype=object)
        parts[0::2] = tdec if k == len(tdec) else tdec[~nan[i]]
        parts[1::2] = vs
        s = "".join(parts)
        # s begins with the first step's '"],[' decoration: drop the '"],'
        # (3 bytes), keep its '[', and prepend/append the array brackets
        out.append(("[" + s[3:] + '"]]').encode())
    return out


def render_rows(ts_s: np.ndarray, vals: np.ndarray) -> list[bytes]:
    """[[t,"v"],...] fragments for every row of a [G,J] matrix sharing one
    step grid (the vectorized numpy assembly)."""
    v64 = np.ascontiguousarray(vals, dtype=np.float64)
    return _rows_numpy(_ts_decorated(ts_s), v64)


def _values_fragment(ts_s: np.ndarray, vals: np.ndarray) -> bytes:
    """[[t,"v"],...] fragment for one series: the vectorized numpy assembly,
    or the per-sample Python form for exotic dtypes (byte-identical)."""
    try:
        v64 = np.ascontiguousarray(vals, dtype=np.float64)
    except (TypeError, ValueError):
        keep = ~np.isnan(vals)
        parts = (
            f'[{_ts3(float(t))},"{_fmt(v)}"]'
            for t, v in zip(ts_s[keep], vals[keep])
        )
        return ("[" + ",".join(parts) + "]").encode()
    return _rows_numpy(_ts_decorated(ts_s), v64[None, :])[0]


def active_render_format() -> str:
    """The fragment renderer serving this process (the
    ``filodb_render_seconds{format}`` label): always ``numpy`` here."""
    return "numpy"


def _host_rows(values, i0: int, i1: int, num_steps: int) -> np.ndarray:
    """Rows [i0, i1) of a grid's values, its first ``num_steps`` steps, on
    the host (one device-to-host copy of that block for a card tensor)."""
    blk = values[i0:i1, :num_steps]
    if isinstance(blk, torch.Tensor):
        return blk.detach().cpu().numpy()
    return np.asarray(blk)


def _grid_blocks(grids, block_rows: int, phases: dict | None):
    """Yield ``(grid, row_offset, host_block)`` for every ``block_rows``-row
    slice of every grid, with the NEXT block's device->host transfer running
    on a helper thread while the caller encodes the current one (Tailwind's
    boundary-as-dataflow framing: D2H and encode as an overlapped pipeline,
    not a barrier). The queue is bounded at 2 blocks, so a slow socket
    back-pressures the helper thread, never the query's own thread, which
    finished with this query before serving began.

    ``phases`` (when given) accumulates:
      transfer  — seconds the helper spent in device fetches
      stall_s   — seconds the encoder sat waiting for a block (D2H-bound)
      stalls    — number of waits above 1ms (filodb_render_stream_stalls)
    """
    import queue
    import threading
    import time as _time

    q: queue.Queue = queue.Queue(maxsize=2)

    def fetch():
        try:
            for g in grids:
                for i0 in range(0, g.n_series, block_rows):
                    i1 = min(i0 + block_rows, g.n_series)
                    t0 = _time.perf_counter()
                    blk = _host_rows(g.values, i0, i1, g.num_steps)
                    if phases is not None:
                        phases["transfer"] = (phases.get("transfer", 0.0)
                                              + _time.perf_counter() - t0)
                    q.put((g, i0, blk))
        except BaseException as e:  # surfaced on the serving thread
            q.put(e)
            return
        q.put(None)

    threading.Thread(target=fetch, daemon=True, name="fdb-d2h-prefetch").start()
    while True:
        t0 = _time.perf_counter()
        item = q.get()
        wait = _time.perf_counter() - t0
        if phases is not None:
            phases["stall_s"] = phases.get("stall_s", 0.0) + wait
            if wait > 1e-3:
                phases["stalls"] = phases.get("stalls", 0) + 1
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def stream_matrix(res: QueryResult, stats: dict | None = None,
                  chunk_target: int = 1 << 18, warnings: list | None = None,
                  trace: dict | None = None, partial: bool = False,
                  block_rows: int | None = None, phases: dict | None = None):
    """Generator of JSON byte chunks for a matrix result envelope.

    The serving-edge answer to reference executeStreaming
    (query/exec/ExecPlan.scala:146) + SerializedRangeVector: root-node memory
    stays bounded by ``chunk_target`` + one series fragment instead of the
    whole rendered matrix (a 100k-series raw export is ~10M samples; the
    non-streaming path held matrix + JSON string concurrently).

    With ``block_rows`` set, grid values are pulled device->host in
    ``block_rows``-series blocks through a double-buffered prefetch thread
    (see _grid_blocks) so the first body bytes leave before the full D2H
    completes and transfer overlaps encode; ``phases`` receives the
    transfer/stall attribution."""
    buf = bytearray()
    buf += b'{"status":"success","data":{"resultType":"matrix","result":['
    first = True

    def emit_frag(labels, frag):
        nonlocal first
        head = b"" if first else b","
        first = False
        return (
            head + b'{"metric":'
            + json.dumps(_labels_out(labels)).encode()
            + b',"values":' + frag + b"}"
        )

    def emit(labels, ts_s, vals, keep_empty):
        frag = _values_fragment(ts_s, vals)
        if frag == b"[]" and not keep_empty:
            return None
        return emit_frag(labels, frag)

    if res.raw is not None:
        for labels, ts, vals in res.raw:
            if vals.ndim != 1:
                # 2-D (histogram-column) raw values would be read as a flat
                # f64 buffer by the native renderer — degrade this series to
                # a Python row-list fragment (same shape as render_matrix's
                # output, with this path's fixed 3-decimal timestamps; no
                # 500 for callers that skip http.py's pre-filter)
                rows = ",".join(
                    f'[{_ts3(t / 1000.0)},{json.dumps(_fmt_val(v))}]'
                    for t, v in zip(ts, vals)
                )
                piece = emit_frag(labels, ("[" + rows + "]").encode())
                if piece:
                    buf += piece
                if len(buf) >= chunk_target:
                    yield bytes(buf)
                    buf.clear()
                continue
            piece = emit(labels, ts.astype(np.float64) / 1e3, vals, True)
            if piece:
                buf += piece
            if len(buf) >= chunk_target:
                yield bytes(buf)
                buf.clear()
    def emit_rows(g, i0, vals_blk, ts_cache):
        ts_s = ts_cache.get(id(g))
        if ts_s is None:
            ts_s = g.step_times_ms().astype(np.float64) / 1e3
            ts_cache[id(g)] = ts_s
        rows = render_rows(ts_s, vals_blk)
        for j, frag in enumerate(rows):
            if frag == b"[]":
                continue
            yield emit_frag(g.labels[i0 + j], frag)

    ts_cache: dict = {}
    if block_rows:
        block_iter = _grid_blocks(res.grids, block_rows, phases)
    else:
        block_iter = ((g, 0, g.values_np()) for g in res.grids)
    for g, i0, vals_blk in block_iter:
        for piece in emit_rows(g, i0, vals_blk, ts_cache):
            buf += piece
            if len(buf) >= chunk_target:
                yield bytes(buf)
                buf.clear()
    buf += b"]"
    if stats is not None:
        buf += b',"stats":' + json.dumps(stats).encode()
    if trace is not None:
        buf += b',"trace":' + json.dumps(trace).encode()
    buf += b"}"  # close data
    if warnings:
        buf += b',"partial":true,"warnings":' + json.dumps(warnings).encode()
    elif partial:
        buf += b',"partial":true'
    buf += b"}"
    yield bytes(buf)


def success(data: Any, warnings: list | None = None, partial: bool = False) -> dict:
    """Success envelope; partial results carry top-level ``warnings`` (the
    Prometheus envelope's warnings slot, structured) + ``"partial": true``."""
    out = {"status": "success", "data": data}
    if warnings:
        out["partial"] = True
        out["warnings"] = warnings
    elif partial:
        out["partial"] = True
    return out


def error(err_type: str, message: str) -> dict:
    return {"status": "error", "errorType": err_type, "error": message}
