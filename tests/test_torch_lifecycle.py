"""The memstore's lifecycle in the port against the JAX package on the same
ingest: the flush cycle's index end times (and their reactivation), append
listeners, the evictable queue, retention eviction, both tiers of headroom
eviction, on-demand paging (selective: the bytes read), cardinality quotas
and exemplars. Both packages must give equal counts, the same surviving
series and equal answers (rtol 2e-4 / atol 1e-4, NaN masks equal; the
port against itself bit for bit across an eviction and its page-in), and
the device ledger's drift stays 0 after each eviction."""

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.cardinality import QuotaExceededError as JaxQuotaExceededError
from filodb_tpu.store import columnstore as JC
from filodb_tpu.store import flush as JF
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.ledger import LEDGER
from filodb_tpu_torch.memstore.cardinality import QuotaExceededError
from filodb_tpu_torch.store import columnstore as PC
from filodb_tpu_torch.store import flush as PF
from test_torch_persistence import (DS, N_SHARDS, SPREAD, START_S, STEP_S, ingest, jax_store,
                                    port_store)
from test_torch_tree import BASE, assert_rows_match, by_labels, make_data

END_S = (BASE + 1_450_000) / 1000
QUERIES = ("sum(rate(http_requests_total[5m]))", "sum by (zone) (max_over_time(node_temp[5m]))",
           "rate(http_requests_total[5m])", "node_temp")


def mirrored(tmp_path, odp: bool, chunk: int = 32, seed: int = 9):
    """Both packages' stores over the same ingest, each flushed to its own
    column store (attached for on-demand paging when ``odp``)."""
    data = make_data("irregular", seed=seed)
    pms, jms = port_store(chunk), jax_store(chunk)
    ingest(pms, jms, data)
    pst, jst = PC.LocalColumnStore(str(tmp_path / "p")), JC.LocalColumnStore(str(tmp_path / "j"))
    PF.FlushCoordinator(pms, pst).flush_all(DS)
    JF.FlushCoordinator(jms, jst).flush_all(DS)
    if odp:
        for s in range(N_SHARDS):
            pms.shard(DS, s).odp_store = pst
            jms.shard(DS, s).odp_store = jst
    return {"data": data, "pms": pms, "jms": jms, "pst": pst, "jst": jst}


def answers(st, query, end_s=END_S):
    got = by_labels(QueryEngine(st["pms"], DS, device="cpu").query_range(
        query, START_S, end_s, STEP_S))
    want = by_labels(JaxEngine(st["jms"], DS).query_range(query, START_S, end_s, STEP_S))
    return got, want


def drift_zero():
    kinds = LEDGER.verify()["kinds"]
    assert all(k["drift"] == 0 for k in kinds.values()), kinds


def shards(st):
    return [(st["pms"].shard(DS, s), st["jms"].shard(DS, s)) for s in range(N_SHARDS)]


def test_index_end_times_follow_jax(tmp_path):
    st = mirrored(tmp_path, odp=False)
    coords = (PF.FlushCoordinator(st["pms"], st["pst"]), JF.FlushCoordinator(st["jms"], st["jst"]))
    # the second flush with no ingest in between ends every series
    for c in coords:
        c.flush_all(DS)
    for ps, js in shards(st):
        assert ps._ended == js._ended and ps._ended == set(ps.partitions)
        for pid in ps.partitions:
            assert ps.index.end_time(pid) == js.index.end_time(pid) < 2**62
        assert ps.update_index_end_times() == js.update_index_end_times() == 0
    # a series that ingests again is live again in both
    tags, schema, ts, vals = st["data"][0]
    later = ts[-1] + 10_000 * np.arange(1, 4)
    ingest(st["pms"], st["jms"], [(tags, schema, later, vals[-3:] + 1)])
    shard = S.shard_for(tags, SPREAD, N_SHARDS)
    ps, js = st["pms"].shard(DS, shard), st["jms"].shard(DS, shard)
    pid = ps._by_partkey[S.canonical_partkey(tags)]
    assert pid not in ps._ended and pid not in js._ended
    assert ps.index.end_time(pid) == js.index.end_time(pid) == 2**62
    # a time-filtered lookup past every ended series finds the live one only
    lo = int(later[0])
    assert list(ps.lookup_partitions([], lo, lo + 1)) == list(js.lookup_partitions([], lo, lo + 1))
    assert list(ps.lookup_partitions([], lo, lo + 1)) == [pid]


def test_append_listeners_hear_what_jax_hears(tmp_path):
    heard = {"port": [], "jax": []}
    pms, jms = port_store(), jax_store()
    for s in range(N_SHARDS):
        pms.shard(DS, s).add_append_listener(lambda *a: heard["port"].append(a))
        jms.shard(DS, s).add_append_listener(lambda *a: heard["jax"].append(a))
    data = make_data("regular", seed=2)
    ingest(pms, jms, [(t, s, ts[:50], v[:50]) for t, s, ts, v in data])
    ingest(pms, jms, [(t, s, ts[50:], v[50:]) for t, s, ts, v in data])
    assert heard["port"] == heard["jax"] and len(heard["port"]) == 2 * len(data)
    assert any(not full for *_, full in heard["port"])  # appends to existing series
    cb = pms.shard(DS, 0)._append_listeners[0]
    pms.shard(DS, 0).remove_append_listener(cb)
    pms.shard(DS, 0).remove_append_listener(cb)  # a second removal is a no-op
    assert not pms.shard(DS, 0)._append_listeners


@pytest.mark.parametrize("cut_min", [8, 16])
def test_retention_matches_jax(tmp_path, cut_min):
    st = mirrored(tmp_path, odp=False)
    cutoff = BASE + cut_min * 60_000
    for ps, js in shards(st):
        now = cutoff + ps.config.retention_ms
        assert ps.evict_for_retention(now) == js.evict_for_retention(now)
        assert sorted(ps.partitions) == sorted(js.partitions)
        assert ps.stats.partitions_evicted == js.stats.partitions_evicted
        for pid, jp in js.partitions.items():
            assert [c.start_ts for c in ps.partitions[pid].chunks] == [
                c.start_ts for c in jp.chunks]
        assert len(ps.index) == len(js.index)
        assert ps.cardinality.scan((), 0)[0].ts_count == js.cardinality.scan((), 0)[0].ts_count
    drift_zero()
    for q in QUERIES:
        got, want = answers(st, q)
        assert_rows_match(got, want, f"retention {q}")


def test_retention_removes_series_that_ended_before_the_cutoff(tmp_path):
    """With a column store attached, a series emptied by retention stays as
    a shell while its index end time lies within retention (still
    ingesting); once a flush cycle has ended it, retention removes it."""
    st = mirrored(tmp_path, odp=True)
    far = BASE + 10**9
    for ps, js in shards(st):
        now = far + ps.config.retention_ms
        n = len(ps.partitions)
        assert ps.evict_for_retention(now) == js.evict_for_retention(now) > 0
        assert len(ps.partitions) == len(js.partitions) == n  # shells for paging
        assert all(p.num_samples() == 0 for p in ps.partitions.values())
    PF.FlushCoordinator(st["pms"], st["pst"]).flush_all(DS)
    JF.FlushCoordinator(st["jms"], st["jst"]).flush_all(DS)
    for ps, js in shards(st):
        now = far + ps.config.retention_ms
        assert ps.evict_for_retention(now) == js.evict_for_retention(now) == 0
        assert not ps.partitions and not js.partitions and len(ps.index) == 0
        assert ps.label_names([], 0, 2**62) == js.label_names([], 0, 2**62) == []
        assert ps.stats.partitions_evicted == js.stats.partitions_evicted > 0
    drift_zero()


def test_headroom_tier_one_keeps_encoded_chunks(tmp_path):
    st = mirrored(tmp_path, odp=False)
    before = {q: answers(st, q)[0] for q in QUERIES}
    for ps, js in shards(st):
        r0 = ps.resident_bytes()
        assert r0 == js.resident_bytes() > 0
        freed = ps.evict_for_headroom(target_bytes=0)
        assert freed == js.evict_for_headroom(target_bytes=0) > 0
        assert ps.resident_bytes() == js.resident_bytes() == r0 - freed
        assert ps.stats.bytes_reclaimed == js.stats.bytes_reclaimed == freed
        assert all(c.arrays is None and c.encoded for p in ps.partitions.values()
                   for c in p.chunks)
        assert ps.evicted_keys == js.evicted_keys == set()  # no store: no tier 2
    drift_zero()
    for q in QUERIES:
        got, want = answers(st, q)
        assert_rows_match(got, want, f"tier 1 {q}")
        assert_rows_match(got, before[q], f"tier 1 {q} vs before", exact=True)


def test_headroom_tier_two_and_page_in_match_jax(tmp_path):
    st = mirrored(tmp_path, odp=True)
    pe = QueryEngine(st["pms"], DS, device="cpu")
    before = {q: by_labels(pe.query_range(q, START_S, END_S, STEP_S)) for q in QUERIES}
    for ps, js in shards(st):
        assert ps.evictable.snapshot() == js.evictable.snapshot()
        freed = ps.evict_for_headroom(target_bytes=0)
        assert freed == js.evict_for_headroom(target_bytes=0) > 0
        assert ps.evicted_keys == js.evicted_keys and ps.evicted_keys
        assert all(not p.chunks for p in ps.partitions.values())
        assert ps.evictable.snapshot() == js.evictable.snapshot() == []
        assert ps.version == js.version
    drift_zero()
    for q in QUERIES:
        got, want = answers(st, q)
        assert_rows_match(got, want, f"paged in {q}")
        again = by_labels(pe.query_range(q, START_S, END_S, STEP_S))
        assert_rows_match(again, before[q], f"paged in {q} vs before", exact=True)
    for ps, js in shards(st):
        assert ps.odp_stats_pages == js.odp_stats_pages > 0
        assert ps.evictable.snapshot() == js.evictable.snapshot()
    drift_zero()


def test_page_in_reads_only_the_asked_series(tmp_path):
    st = mirrored(tmp_path, odp=True)
    for ps, js in shards(st):
        ps.evict_for_headroom(target_bytes=0)
        js.evict_for_headroom(target_bytes=0)
    st["pst"].stats_selective_bytes = st["jst"].stats_selective_bytes = 0
    q = 'rate(http_requests_total{instance="host-1"}[5m])'
    got, want = answers(st, q)
    assert_rows_match(got, want, q)
    assert len(got) == 1
    read = st["pst"].stats_selective_bytes
    assert read == st["jst"].stats_selective_bytes > 0
    total = sum(e["len"] for s in range(N_SHARDS) for e in st["pst"]._manifest(DS, s) or [])
    assert read < total / 4
    pages = sum(ps.odp_stats_pages for ps, _ in shards(st))
    assert pages == sum(js.odp_stats_pages for _, js in shards(st)) > 0


def test_a_page_in_build_is_cached_at_its_new_version(tmp_path):
    """The fused build that pages chunks in stamps its superblock with the
    paged-in version: the next query is a cache hit."""
    st = mirrored(tmp_path, odp=True)
    for ps, _ in shards(st):
        ps.evict_for_headroom(target_bytes=0)
    pe = QueryEngine(st["pms"], DS, device="cpu")
    q = QUERIES[0]
    first = pe.query_range(q, START_S, END_S, STEP_S)
    assert sum(ps.odp_stats_pages for ps, _ in shards(st)) > 0
    second = pe.query_range(q, START_S, END_S, STEP_S)
    assert second.stats.cache_hits == 1 and second.stats.cache_misses == 0
    np.testing.assert_array_equal(first.grids[0].values_np(), second.grids[0].values_np())


def test_eviction_drops_the_stale_superblocks(tmp_path):
    st = mirrored(tmp_path, odp=True)
    pe = QueryEngine(st["pms"], DS, device="cpu")
    pe.query_range(QUERIES[0], START_S, END_S, STEP_S)
    cache = st["pms"]._superblock_cache
    assert len(cache) == 1 and cache.ledger.bytes > 0
    st["pms"].shard(DS, 0).evict_for_headroom(target_bytes=0)
    assert len(cache) == 0 and cache.ledger.bytes == 0
    drift_zero()


def test_quotas_raise_at_the_series_jax_raises(tmp_path):
    pms, jms = port_store(), jax_store()
    for ms in (pms, jms):
        for s in range(N_SHARDS):
            ms.shard(DS, s).cardinality.set_quota(("demo",), 2)
            ms.shard(DS, s).cardinality.set_quota(("demo", "App-2", "node_temp"), 1)
    outcome = {"port": [], "jax": []}
    for tags, schema, ts, vals in make_data("regular", seed=1):
        tags = dict(tags, _ws_="demo")
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        col = "count" if schema == "prom-counter" else "value"
        try:
            pms.shard(DS, shard).ingest_series(SeriesBatch(S.SCHEMAS[schema], tags, ts,
                                                           {col: vals}))
            outcome["port"].append("ok")
        except QuotaExceededError as e:
            outcome["port"].append(("quota", e.prefix, e.quota, str(e)))
        try:
            jms.shard(DS, shard).ingest_series(JaxSeriesBatch(JS.SCHEMAS[schema], tags, ts,
                                                              {col: vals}))
            outcome["jax"].append("ok")
        except JaxQuotaExceededError as e:
            outcome["jax"].append(("quota", e.prefix, e.quota, str(e)))
    assert outcome["port"] == outcome["jax"]
    assert "ok" in outcome["port"] and any(o != "ok" for o in outcome["port"])
    for s in range(N_SHARDS):
        ps, js = pms.shard(DS, s), jms.shard(DS, s)
        assert sorted(ps._by_partkey) == sorted(js._by_partkey)
        assert [(r.prefix, r.ts_count, r.active_ts_count) for r in ps.cardinality.scan((), 1)] \
            == [(r.prefix, r.ts_count, r.active_ts_count) for r in js.cardinality.scan((), 1)]


def test_cardinality_snapshot_round_trips_with_jax(tmp_path):
    from filodb_tpu.memstore.cardinality import CardinalityTracker as JaxTracker
    from filodb_tpu_torch.memstore.cardinality import CardinalityTracker

    pt, jt = CardinalityTracker(), JaxTracker()
    for t in (pt, jt):
        t.set_quota(("demo", "App-1"), 7)
        for i in range(5):
            t.series_created({"_ws_": "demo", "_ns_": f"App-{i % 2}", "_metric_": f"m{i}"})
        t.series_stopped({"_ws_": "demo", "_ns_": "App-0", "_metric_": "m0"})
        t.series_removed({"_ws_": "demo", "_ns_": "App-1", "_metric_": "m1"})
    pt.save(str(tmp_path / "p.json"))
    jt.save(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    back = CardinalityTracker.load(str(tmp_path / "j.json"))
    assert back.quota_of(("demo", "App-1")) == 7
    assert [(r.prefix, r.ts_count, r.active_ts_count, r.children) for r in back.scan((), 2)] == [
        (r.prefix, r.ts_count, r.active_ts_count, r.children) for r in jt.scan((), 2)]


def test_exemplars_match_jax(tmp_path):
    st = mirrored(tmp_path, odp=False)
    items = []
    for i, (tags, *_rest) in enumerate(st["data"][:6]):
        for k in range(3):
            items.append((tags, BASE + 600_000 + k * 1000 + i, 0.5 * i + k,
                          {"trace_id": f"t{i}-{k}"}))
    items.append(({S.METRIC_TAG: "no_such_series"}, BASE, 1.0, {"trace_id": "x"}))
    n = st["pms"].add_exemplars(DS, SPREAD, items)
    assert n == st["jms"].add_exemplars(DS, SPREAD, items) == len(items) - 1
    from filodb_tpu.core.filters import ColumnFilter as JaxFilter
    from filodb_tpu_torch.core.filters import ColumnFilter

    for lo, hi in ((0, 2**62), (BASE + 600_001, BASE + 601_003)):
        got = st["pms"].query_exemplars(DS, [ColumnFilter(S.METRIC_TAG, "=",
                                                          "http_requests_total")], lo, hi)
        want = st["jms"].query_exemplars(DS, [JaxFilter(S.METRIC_TAG, "=",
                                                        "http_requests_total")], lo, hi)
        assert got == want and got


def test_encode_on_seal_matches_jax():
    """With ``encode_on_seal`` a sealed chunk carries its encoded form at
    once, the JAX package's bytes, and ``_filodb_chunkmeta_all`` reports it
    before any flush; tier 1 keeps the answers."""
    from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
    from filodb_tpu.memstore.shard import StoreConfig as JaxStoreConfig
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    pms = TimeSeriesMemStore(StoreConfig(max_chunk_size=32, encode_on_seal=True))
    jms = JaxMemStore(JaxStoreConfig(max_chunk_size=32, encode_on_seal=True,
                                     index_backend="set"))
    pms.setup(S.Dataset(DS), range(N_SHARDS))
    jms.setup(JS.Dataset(DS), range(N_SHARDS))
    ingest(pms, jms, make_data("irregular", seed=14))
    st = {"pms": pms, "jms": jms}
    for ps, js in shards(st):
        for pid, jp in js.partitions.items():
            pp = ps.partitions[pid]
            assert len(pp.chunks) == len(jp.chunks) > 0
            for c, jc in zip(pp.chunks, jp.chunks):
                assert c.encoded is not None and c.arrays is not None
                assert {k: e.to_bytes() for k, e in c.encoded.items()} == {
                    k: e.to_bytes() for k, e in jc.encoded.items()}
    q = "_filodb_chunkmeta_all(node_temp)"
    got, want = (e.query_range(q, START_S, END_S, STEP_S).metadata for e in (
        QueryEngine(pms, DS, device="cpu"), JaxEngine(jms, DS)))
    assert got == want and all(c["encodedBytes"] > 0 for r in got for c in r["chunks"])
    before = {q: answers(st, q)[0] for q in QUERIES}
    for ps, js in shards(st):
        for p in list(ps.partitions.values()) + list(js.partitions.values()):
            p.mark_flushed(p.chunks[-1].end_ts)
        assert ps.evict_for_headroom(target_bytes=0) == js.evict_for_headroom(target_bytes=0)
    for q in QUERIES:
        got, want = answers(st, q)
        assert_rows_match(got, want, f"encoded on seal {q}")
        assert_rows_match(got, before[q], f"encoded on seal {q} vs before", exact=True)
