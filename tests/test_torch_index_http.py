"""The part-key index at the port's server edge against the JAX handler:
``/debug/index`` (with ``?label=`` drill-down) answers 200 with the JAX
payload's shape and, over the same store, its numbers; the three
``filodb_index_*`` gauges on ``/metrics`` equal the JAX server's per shard;
the device tier's staged bitmaps show there when it is on; and the
server takes ``index_backend`` "python", "native" and "set" and
``index_device_postings``, passing them to every shard."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from filodb_tpu.api import http as JHTTP
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu_torch.api import http as HTTP
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.memstore.index import PartKeyIndex, SetBasedPartKeyIndex
from filodb_tpu_torch.memstore.index_device import DevicePostingsTier
from filodb_tpu_torch.memstore.index_native import NativePartKeyIndex
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.memstore.shard import StoreConfig
from filodb_tpu_torch.server import FiloServer
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from tests.test_torch_engine import (
    END_S, N_SHARDS, SPREAD, START_S, STEP_S, build_stores, make_data,
)
from tests.test_torch_http import GRID, get, serve

INDEX_GAUGES = ("filodb_index_postings_bytes", "filodb_index_dictionary_size",
                "filodb_index_device_staged_bytes")


@pytest.fixture(scope="module")
def servers():
    jms, pms = build_stores(make_data("irregular", seed=5))
    jsrv, jbase = serve(JaxEngine(jms, "prometheus"), JHTTP)
    psrv, pbase = serve(QueryEngine(pms, "prometheus", device="cpu"), HTTP)
    yield jbase, pbase
    for srv in (jsrv, psrv):
        srv.shutdown()
        srv.server_close()


def debug_index(base: str, query: str = ""):
    status, _, body = get(base, "/debug/index" + query)
    return status, json.loads(body)


def keys_deep(x):
    """The payload's shape: its keys, recursively, with lists by their
    first element."""
    if isinstance(x, dict):
        return {k: keys_deep(v) for k, v in x.items()}
    if isinstance(x, list):
        return [keys_deep(x[0])] if x else []
    return type(x).__name__


@pytest.mark.parametrize("query", ["", "?label=instance", "?label=zone", "?label=absent"])
def test_debug_index_equals_jax(servers, query):
    jbase, pbase = servers
    # the same selector traffic on both sides first
    for base in servers:
        get(base, "/api/v1/query_range?query=sum(rate(http_requests_total[5m]))" + GRID)
    (ws, want), (gs, got) = debug_index(jbase, query), debug_index(pbase, query)
    assert gs == ws == 200
    assert keys_deep(got) == keys_deep(want)
    g, w = got["data"], want["data"]
    assert g["labels"] == w["labels"]
    assert g["postings_bytes"] == w["postings_bytes"] > 0
    assert g["device_staged_bytes"] == w["device_staged_bytes"] == 0
    assert g["label_values"] == w["label_values"]
    for gs_, ws_ in zip(g["shards"], w["shards"]):
        assert {k: v for k, v in gs_.items() if k != "lookups"} == \
            {k: v for k, v in ws_.items() if k != "lookups"}
        assert gs_["lookups"] > 0
    if query.endswith("zone"):
        assert {r["value"] for r in g["label_values"]} == {"z0", "z1", "z2", "z3"}


def gauges(text: str) -> dict:
    """The index gauges of the fixture's shards (a registry is per process:
    a store of more shards that an earlier test served leaves its gauges
    for the higher shard numbers behind)."""
    out = {}
    for line in text.splitlines():
        m = re.match(r'(filodb_index_\w+)\{dataset="prometheus",shard="(\d+)"\} (\S+)', line)
        if m and int(m[2]) < N_SHARDS:
            out[(m[1], int(m[2]))] = float(m[3])
    return out


def test_index_gauges_equal_jax(servers):
    jbase, pbase = servers
    want = gauges(get(jbase, "/metrics")[2].decode())
    got = gauges(get(pbase, "/metrics")[2].decode())
    assert got == want
    assert set(got) == {(name, s) for name in INDEX_GAUGES for s in range(N_SHARDS)}
    text = get(pbase, "/metrics")[2].decode()
    for name in INDEX_GAUGES:
        assert f"# HELP {name} " in text and f"# TYPE {name} gauge" in text


@pytest.mark.parametrize("backend,cls", [("python", PartKeyIndex), ("native", NativePartKeyIndex),
                                         ("set", SetBasedPartKeyIndex)])
def test_server_takes_every_index_backend(backend, cls):
    srv = FiloServer({"index_backend": backend, "shards": 2}, device="cpu")
    assert srv.store_config.index_backend == backend
    assert all(type(sh.index) is cls for sh in srv.memstore.shards(srv.dataset))


def test_server_takes_the_device_tier():
    srv = FiloServer({"index_device_postings": True, "index_device_min_hits": 2,
                      "index_device_max_bytes": 1 << 20, "shards": 2}, device="cpu")
    for sh in srv.memstore.shards(srv.dataset):
        tier = sh.index.device_tier
        assert isinstance(tier, DevicePostingsTier)
        assert (str(tier.device), tier.min_hits, tier.max_bytes) == ("cpu", 2, 1 << 20)
    with pytest.raises(ValueError, match="index_device_postings needs"):
        FiloServer({"index_device_postings": True, "index_backend": "native"}, device="cpu")


def test_debug_index_shows_the_staged_bitmaps():
    """With the tier on (on the CPU), the equality selectors of a query
    stage after min_hits and /debug/index reports the staged bitmaps, the
    ledger's bytes and the tier's counters per shard."""
    pms = TimeSeriesMemStore(StoreConfig(index_device_postings=True, index_device="cpu",
                                         index_device_min_hits=2))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in make_data("regular", seed=6):
        col = "count" if schema == "prom-counter" else "value"
        pms.shard("prometheus", S.shard_for(tags, SPREAD, N_SHARDS)).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    engine = QueryEngine(pms, "prometheus", device="cpu")
    q = 'sum(rate(http_requests_total{_ns_="App-2"}[5m]))'
    want = engine.query_range(q, START_S, END_S, STEP_S).grids[0].values_np()
    for _ in range(2):
        pms._superblock_cache = None  # cold again: the selector is looked up
        engine.query_range(q, START_S, END_S, STEP_S)
    staged = {sh.shard_num: sh.index.device_tier.maintain() for sh in pms.shards("prometheus")}
    holders = {sh.shard_num for sh in pms.shards("prometheus")
               if "App-2" in sh.index.value_counts("_ns_")}
    # _ns_ and _metric_ on every shard that holds the tenant's series
    assert staged == {s: 2 if s in holders else 0 for s in range(N_SHARDS)} and holders
    pms._superblock_cache = None
    got = engine.query_range(q, START_S, END_S, STEP_S).grids[0].values_np()
    np.testing.assert_array_equal(got, want)
    srv, base = serve(engine, HTTP)
    try:
        status, payload = debug_index(base)
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 200
    data = payload["data"]
    assert data["device_staged_bytes"] == sum(
        sh["device"]["staged_bytes"] for sh in data["shards"]) > 0
    for sh in data["shards"]:
        dev = sh["device"]
        assert dev["ledger_bytes"] == dev["staged_bytes"]
        if sh["shard"] in holders:
            assert {e["label"] for e in dev["staged"]} == {"_ns_", "_metric_"}
            assert dev["stats"]["intersections"] >= 1
        else:
            assert dev["staged"] == [] and dev["stats"]["intersections"] == 0
