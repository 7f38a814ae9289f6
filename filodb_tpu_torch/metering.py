"""Per-query tenant attribution (counterpart of the tenant helpers of
``filodb_tpu/metering.py``): the tenant a query's selectors pin, and the
overflow cap that bounds tenant label cardinality. Admission control
(``query/scheduler.AdmissionController``) keys its quotas and counters on
them. The rest of the JAX module (ingestion metering, label churn, the
per-tenant resource counters) is ROADMAP A6.
"""

from __future__ import annotations

import threading


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
