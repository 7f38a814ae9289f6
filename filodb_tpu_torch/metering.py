"""Per-query tenant attribution (counterpart of the tenant helpers of
``filodb_tpu/metering.py``): the tenant a query's selectors pin, and the
overflow cap that bounds tenant label cardinality. Admission control
(``query/scheduler.AdmissionController``) keys its quotas and counters on
them; standing refreshes charge their tenant through
``record_tenant_query``. The rest of the JAX module (ingestion metering,
label churn) is ROADMAP A6.
"""

from __future__ import annotations

import threading

from .metrics import REGISTRY


def tenant_of_filters(filters) -> tuple[str | None, str | None]:
    """(ws, ns) from equality matchers on the shard-key tenant columns
    (``_ws_``/``_ns_``); None components when the filters don't pin one."""
    ws = ns = None
    for f in filters or ():
        if getattr(f, "op", None) != "=":
            continue
        if f.column == "_ws_":
            ws = str(f.value)
        elif f.column == "_ns_":
            ns = str(f.value)
    return ws, ns


def tenant_of_plan(plan) -> tuple[str, str]:
    """The query's tenant from its logical plan's raw-series leaves.
    Multi-tenant or tenant-less selections attribute to ``unknown``; quotas
    act on pinned tenants."""
    from .query.logical import leaf_raw_series

    try:
        leaves = leaf_raw_series(plan)
    except Exception:  # noqa: BLE001 — metadata plans have no series leaves
        leaves = []
    ws = ns = None
    for leaf in leaves:
        lws, lns = tenant_of_filters(getattr(leaf, "filters", ()))
        if lws is not None:
            if ws is not None and ws != lws:
                return "unknown", "unknown"  # cross-tenant query
            ws = lws
        if lns is not None:
            if ns is not None and ns != lns:
                return "unknown", "unknown"
            ns = lns
    return ws or "unknown", ns or "unknown"


# tenant labels come from client-supplied query matchers: without a bound, a
# scripted loop of made-up _ws_ values grows the registry forever. Past the
# cap, new pairs pool into "overflow".
MAX_TENANT_PAIRS = 256
_tenant_pairs: set[tuple[str, str]] = set()
_tenant_pairs_lock = threading.Lock()


def bounded_tenant_pair(ws: str, ns: str) -> tuple[str, str]:
    """The pair itself when it is already known or the cap has room, else
    ``("overflow", "overflow")``."""
    with _tenant_pairs_lock:
        if (ws, ns) not in _tenant_pairs:
            if len(_tenant_pairs) >= MAX_TENANT_PAIRS:
                return "overflow", "overflow"
            _tenant_pairs.add((ws, ns))
    return ws, ns


def record_tenant_query(ws: str, ns: str, query_seconds: float, kernel_seconds: float,
                        bytes_staged: int) -> None:
    """Add one finished query (or standing refresh) to its tenant's
    resource counters, the JAX package's families:
    ``filodb_tenant_queries_total``, ``filodb_tenant_query_seconds_total``
    (wall), ``filodb_tenant_query_latency_seconds`` (histogram),
    ``filodb_tenant_kernel_seconds_total`` (the host wall of the fused
    launches) and ``filodb_tenant_bytes_staged_total``; the tenant pair is
    bounded (``bounded_tenant_pair``)."""
    ws, ns = bounded_tenant_pair(ws, ns)
    REGISTRY.counter("filodb_tenant_queries", ws=ws, ns=ns).inc()
    REGISTRY.counter("filodb_tenant_query_seconds", ws=ws, ns=ns).inc(float(query_seconds))
    REGISTRY.histogram("filodb_tenant_query_latency_seconds", ws=ws, ns=ns).observe(
        float(query_seconds))
    REGISTRY.counter("filodb_tenant_kernel_seconds", ws=ws, ns=ns).inc(float(kernel_seconds))
    REGISTRY.counter("filodb_tenant_bytes_staged", ws=ws, ns=ns).inc(int(bytes_staged))
