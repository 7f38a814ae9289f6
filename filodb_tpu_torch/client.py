"""Python client for a server (counterpart of ``filodb_tpu/client.py``;
reference L5 client/LocalClient.scala): a thin typed wrapper over the HTTP
API with gzip, bearer auth and bounded retries (``fetch_json``, the port's
own copy of the JAX package's transport).

    from filodb_tpu_torch.client import FiloClient
    c = FiloClient("http://localhost:9090", token="...")
    c.ingest_prom('http_requests_total{job="api"} 42 1600000000000')
    ts, series = c.query_range('rate(http_requests_total[5m])', 1600000350, 1600000590, 60)

The JAX client's gRPC transport (``grpc_endpoint``) and Arrow result
frames are not ported: the first raises (ROADMAP A9), results always come
as JSON. Its failover siblings (replicated frontends, A9) and exemplar
reads (A4) are left out.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Mapping, Sequence

import numpy as np

from .query.exec.transformers import QueryError

_RETRIES = 3
_BACKOFF_S = (0.05, 0.2)


class RemoteFetchError(QueryError):
    """A transport-level failure that outlived the retries (5xx, connection
    errors, timeouts)."""

    endpoint_failure = True


def fetch_raw(url: str, auth_token: str | None = None, timeout: float = 60,
              data: dict | None = None, extra_headers: dict | None = None) -> tuple:
    """GET (or, with ``data``, a JSON POST) with gzip transport, bearer auth
    and bounded retries with backoff on transient failures (5xx, connection
    errors, timeouts; a 4xx fails at once). ``timeout`` is the total
    budget. Returns ``(body bytes, response headers)``, gzip undone."""
    import gzip
    import time as _time
    import urllib.error

    headers = {"Accept-Encoding": "gzip"}
    if auth_token:
        headers["Authorization"] = f"Bearer {auth_token}"
    if extra_headers:
        headers.update(extra_headers)
    body = None
    if data is not None:
        body = json.dumps(data).encode()
        headers["Content-Type"] = "application/json"
    deadline = _time.monotonic() + timeout
    last_err: Exception | None = None
    for attempt in range(_RETRIES):
        per_attempt = deadline - _time.monotonic()
        if per_attempt <= 0:
            break
        try:
            req = urllib.request.Request(url, data=body, headers=headers)
            with urllib.request.urlopen(req, timeout=per_attempt) as r:
                raw = r.read()
                if r.headers.get("Content-Encoding") == "gzip":
                    raw = gzip.decompress(raw)
                return raw, r.headers
        except urllib.error.HTTPError as e:
            if e.code < 500:
                raise QueryError(f"remote request failed: HTTP {e.code} {e.reason}") from e
            last_err = e  # 5xx: transient, retry
        except (urllib.error.URLError, TimeoutError, ConnectionError) as e:
            last_err = e
        if attempt < _RETRIES - 1:
            backoff = _BACKOFF_S[min(attempt, len(_BACKOFF_S) - 1)]
            if _time.monotonic() + backoff >= deadline:
                break
            _time.sleep(backoff)
    raise RemoteFetchError(f"remote request failed after retries: {last_err}")


def fetch_json(url: str, auth_token: str | None = None, timeout: float = 60,
               data: dict | None = None, want_envelope: bool = False,
               extra_headers: dict | None = None):
    """``fetch_raw`` plus the Prometheus envelope: the ``data`` payload of a
    successful answer (the whole envelope with ``want_envelope``)."""
    raw, _ = fetch_raw(url, auth_token=auth_token, timeout=timeout, data=data,
                       extra_headers=extra_headers)
    payload = json.loads(raw)
    if payload.get("status") != "success":
        raise QueryError(f"remote request failed: {payload}")
    return payload if want_envelope else payload["data"]


class FiloClient:
    def __init__(self, endpoint: str, token: str | None = None, timeout: float = 60,
                 grpc_endpoint: str | None = None):
        if grpc_endpoint:
            raise NotImplementedError(
                "the gRPC RemoteExec transport is not ported to filodb_tpu_torch yet "
                "(ROADMAP A9)")
        self.endpoint = endpoint.rstrip("/")
        self.token = token
        self.timeout = timeout

    # -- queries ---------------------------------------------------------------

    def _url(self, path: str, **params) -> str:
        qs = urllib.parse.urlencode(
            [(k, v) for k, vs in params.items()
             for v in (vs if isinstance(vs, (list, tuple)) else [vs]) if v is not None])
        return f"{path}" + (f"?{qs}" if qs else "")

    def _get(self, path: str, **params):
        return fetch_json(f"{self.endpoint}{self._url(path, **params)}", auth_token=self.token,
                          timeout=self.timeout)

    def query_range(self, promql: str, start_s: float, end_s: float, step_s: float):
        """-> (times_s[np.ndarray], [{"metric": labels, "values": np.ndarray}]).
        Values align on the shared step grid; missing steps are NaN."""
        step_ms = max(round(step_s * 1000), 1)
        n = round((end_s - start_s) * 1000) // step_ms + 1
        times = start_s + np.arange(n) * (step_ms / 1000.0)
        data = self._get("/api/v1/query_range", query=promql, start=start_s, end=end_s,
                         step=step_s)
        t2i = {round(float(t) * 1000): i for i, t in enumerate(times)}
        series = []
        for s in data.get("result", []):
            row = np.full(n, np.nan)
            for t, v in s.get("values", []):
                i = t2i.get(round(float(t) * 1000))
                if i is not None:
                    row[i] = float(v)
            series.append({"metric": s.get("metric", {}), "values": row})
        return times, series

    def query(self, promql: str, time_s: float | None = None):
        """Instant query -> the raw Prometheus ``data`` payload."""
        return self._get("/api/v1/query", query=promql, time=time_s)

    def labels(self, match: str | None = None) -> list[str]:
        return self._get("/api/v1/labels", **{"match[]": match})

    def label_values(self, label: str, match: str | None = None,
                     limit: int | None = None) -> list[str]:
        return self._get(f"/api/v1/label/{urllib.parse.quote(label)}/values",
                         **{"match[]": match, "limit": limit})

    def series(self, match: str) -> list[Mapping[str, str]]:
        return self._get("/api/v1/series", **{"match[]": match})

    def metadata(self) -> Mapping[str, list]:
        return self._get("/api/v1/metadata")

    def cardinality(self, prefix: Sequence[str] = (), depth: int | None = None):
        return self._get("/api/v1/cardinality", prefix=",".join(prefix) or None, depth=depth)

    # -- ingest / admin ----------------------------------------------------------

    def _post(self, path: str, body: bytes, content_type: str = "text/plain"):
        headers = {"Content-Type": content_type}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(f"{self.endpoint}{path}", data=body, headers=headers,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            payload = json.loads(r.read())
        if payload.get("status") != "success":
            raise RuntimeError(f"ingest failed: {payload}")
        return payload["data"]

    def ingest_prom(self, exposition_text: str) -> int:
        """Prometheus text exposition; returns the rows ingested."""
        return self._post("/ingest/prom", exposition_text.encode())["ingested"]

    def ingest_influx(self, lines: str) -> int:
        return self._post("/ingest/influx", lines.encode())["ingested"]

    def ingest_rows(self, rows: Sequence[Mapping]) -> int:
        """JSON-lines ingest: {"tags": {...}, "ts_ms": int, "value": float}."""
        body = "\n".join(json.dumps(dict(r)) for r in rows).encode()
        return self._post("/ingest", body, "application/json")["ingested"]

    def health(self) -> Mapping:
        with urllib.request.urlopen(f"{self.endpoint}/admin/health",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())
