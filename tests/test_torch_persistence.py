"""The port's column store, flush and recovery (``filodb_tpu_torch/store/``)
against the JAX package's (``filodb_tpu/store/``), both ways: the same
ingest flushed by each package writes the same files byte for byte; a
store the port flushed is recovered by the JAX package's ``recover_shard``
and a store the JAX package flushed by the port's, and after recovery a
fused ``sum(rate)``, a ``sum by (zone)`` and a tree ``rate`` match the JAX
engine's (rtol 2e-4, atol 1e-4, NaN masks equal). Also: a torn manifest
line, a truncated segment, the manifest's backfill and repair, selective
reads (the bytes they read), racing flushes that never write a chunk
twice, what both packages answer for a recovered native-histogram store,
and ``encodedBytes`` of flushed chunks."""

import os
import threading

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.memstore.shard import StoreConfig as JaxStoreConfig
from filodb_tpu.store import columnstore as JC
from filodb_tpu.store import flush as JF
from filodb_tpu.testkit import histogram_batch
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import RecordBatch, SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.memstore.shard import StoreConfig
from filodb_tpu_torch.store import columnstore as PC
from filodb_tpu_torch.store import flush as PF
from test_torch_tree import BASE, assert_rows_match, by_labels, make_data

N_SHARDS, SPREAD, CHUNK = 4, 3, 64  # spread 3 puts series on every shard
START_S, END_S, STEP_S = (BASE + 400_000) / 1000, (BASE + 1_400_000) / 1000, 60
QUERIES = ("sum(rate(http_requests_total[5m]))",
           "sum by (zone) (rate(http_requests_total[5m]))",
           "rate(http_requests_total[5m])")
DS = "prometheus"


def ingest(pms, jms, data):
    for tags, schema, ts, vals in data:
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        if jms is not None:
            jms.shard(DS, shard).ingest_series(JaxSeriesBatch(
                schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        if pms is not None:
            pms.shard(DS, shard).ingest_series(SeriesBatch(
                schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))


def port_store(chunk: int = CHUNK) -> TimeSeriesMemStore:
    ms = TimeSeriesMemStore(StoreConfig(max_chunk_size=chunk))
    ms.setup(S.Dataset(DS), range(N_SHARDS))
    return ms


def jax_store(chunk: int = CHUNK) -> JaxMemStore:
    ms = JaxMemStore(JaxStoreConfig(max_chunk_size=chunk, index_backend="set"))
    ms.setup(JS.Dataset(DS), range(N_SHARDS))
    return ms


def tree_files(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def flushed(tmp_path_factory):
    """The irregular counters and gauges of ``test_torch_tree``, ingested
    into both packages (64-sample chunks), each flushed to its own root."""
    data = make_data("irregular", seed=3)
    pms, jms = port_store(), jax_store()
    ingest(pms, jms, data)
    roots = {k: str(tmp_path_factory.mktemp(f"store_{k}")) for k in ("port", "jax")}
    pres = PF.FlushCoordinator(pms, PC.LocalColumnStore(roots["port"])).flush_all(DS)
    jres = JF.FlushCoordinator(jms, JC.LocalColumnStore(roots["jax"])).flush_all(DS)
    return {"data": data, "pms": pms, "jms": jms, "roots": roots, "pres": pres, "jres": jres}


def test_flush_writes_the_jax_packages_files(flushed):
    pres, jres = flushed["pres"], flushed["jres"]
    assert (pres.chunks_written, pres.partkeys_written, pres.groups_flushed) == (
        jres.chunks_written, jres.partkeys_written, jres.groups_flushed)
    assert pres.chunks_written > pres.partkeys_written  # several chunks a series
    got, want = tree_files(flushed["roots"]["port"]), tree_files(flushed["roots"]["jax"])
    assert sorted(got) == sorted(want)
    assert any(k.endswith("manifest.jsonl") for k in got)
    for name in want:
        assert got[name] == want[name], name


def recovered(root: str, by: str):
    if by == "port":
        ms = port_store(400)
        offsets = [PF.recover_shard(ms, PC.LocalColumnStore(root), DS, s)
                   for s in range(N_SHARDS)]
    else:
        ms = jax_store(400)
        offsets = [JF.recover_shard(ms, JC.LocalColumnStore(root), DS, s)
                   for s in range(N_SHARDS)]
    return ms, offsets


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_recovery_answers_match_jax_both_ways(flushed, writer, reader, query):
    """The store one package wrote, recovered by the other, answers as the
    JAX engine over the pre-flush store and over its own recovery."""
    ms, offsets = recovered(flushed["roots"][writer], reader)
    assert offsets == [-1] * N_SHARDS  # nothing ingested with an offset
    if reader == "port":
        got = by_labels(QueryEngine(ms, DS, device="cpu").query_range(
            query, START_S, END_S, STEP_S))
        jms, _ = recovered(flushed["roots"][writer], "jax")
    else:
        pms, _ = recovered(flushed["roots"][writer], "port")
        got = by_labels(QueryEngine(pms, DS, device="cpu").query_range(
            query, START_S, END_S, STEP_S))
        jms = ms
    want = by_labels(JaxEngine(jms, DS).query_range(query, START_S, END_S, STEP_S))
    assert_rows_match(got, want, f"{writer}->{reader} {query}")
    before = by_labels(JaxEngine(flushed["jms"], DS).query_range(query, START_S, END_S, STEP_S))
    assert_rows_match(got, before, f"{writer}->{reader} {query} vs before the flush")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recovered_partitions_match_jax(flushed, writer):
    pms, _ = recovered(flushed["roots"][writer], "port")
    jms, _ = recovered(flushed["roots"][writer], "jax")
    for s in range(N_SHARDS):
        ps, js = pms.shard(DS, s), jms.shard(DS, s)
        assert list(ps._by_partkey) == list(js._by_partkey)
        assert ps._ended == js._ended and len(ps.evictable) == len(js.evictable)
        for pid, jp in js.partitions.items():
            pp = ps.partitions[pid]
            assert pp.schema.name == jp.schema.name
            assert [(c.start_ts, c.end_ts, c.n) for c in pp.chunks] == [
                (c.start_ts, c.end_ts, c.n) for c in jp.chunks]
            assert pp.flushed_until == jp.flushed_until
            assert (pp.earliest_ts(), pp.latest_ts()) == (jp.earliest_ts(), jp.latest_ts())
            assert ps.index.start_time(pid) == js.index.start_time(pid)
            assert ps.index.end_time(pid) == js.index.end_time(pid)
            for c, jc in zip(pp.chunks, jp.chunks):
                for col in jc.arrays:
                    np.testing.assert_array_equal(c.column(col), jc.column(col))
                    assert c.column(col).dtype == jc.column(col).dtype


def test_a_flush_whose_first_shard_is_empty(tmp_path):
    """The port's store makes the dataset's directory for a checkpoint
    written before any chunk; the JAX package's raises (ROADMAP C)."""
    tags = {S.METRIC_TAG: "m", "instance": "on-shard-3"}
    assert S.shard_for(tags, SPREAD, N_SHARDS) != 0
    ts, vals = BASE + np.arange(10, dtype=np.int64) * 1000, np.arange(10.0)
    pms, jms = port_store(), jax_store()
    ingest(pms, jms, [(tags, "gauge", ts, vals)])
    res = PF.FlushCoordinator(pms, PC.LocalColumnStore(str(tmp_path / "p"))).flush_all(DS)
    assert (res.chunks_written, res.partkeys_written) == (1, 1)
    with pytest.raises(FileNotFoundError):
        JF.FlushCoordinator(jms, JC.LocalColumnStore(str(tmp_path / "j"))).flush_all(DS)
    rms, _ = recovered(str(tmp_path / "p"), "port")
    assert sum(len(rms.shard(DS, s).partitions) for s in range(N_SHARDS)) == 1


def test_checkpoints_round_trip(tmp_path):
    data = make_data("regular", seed=4)[:6]
    pms = port_store()
    ingest(pms, None, data)
    for s in range(N_SHARDS):
        pms.shard(DS, s)._ingested_offset = 100 + s
    roots = {"port": str(tmp_path / "p"), "jax": str(tmp_path / "j")}
    PF.FlushCoordinator(pms, PC.LocalColumnStore(roots["port"])).flush_all(DS)
    for reader in ("port", "jax"):
        _, offsets = recovered(roots["port"], reader)
        assert offsets == [100 + s for s in range(N_SHARDS)]
    st_p, st_j = PC.LocalColumnStore(roots["port"]), JC.LocalColumnStore(roots["port"])
    for s in range(N_SHARDS):
        assert st_p.read_checkpoints(DS, s) == st_j.read_checkpoints(DS, s)


def shard_dir(root, shard=0):
    return os.path.join(root, DS, f"shard-{shard}")


def copy_tree(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return str(dst)


def selective(store, shard, tags_list, lo=0, hi=2**62):
    keys = [S.canonical_partkey(t) for t in tags_list]
    return [(h["start"], h["end"], h["n"]) for h, _, _ in
            store.read_chunks_selective(DS, shard, keys, lo, hi)]


def shard_tags(flushed, shard):
    return [t for t, *_ in flushed["data"] if S.shard_for(t, SPREAD, N_SHARDS) == shard]


def test_selective_reads_and_their_bytes_match_jax(flushed):
    root = flushed["roots"]["port"]
    for shard in range(N_SHARDS):
        tags = shard_tags(flushed, shard)
        if not tags:
            continue
        p, j = PC.LocalColumnStore(root), JC.LocalColumnStore(root)
        for pick in (tags[:1], tags[::2], tags):
            for lo, hi in ((0, 2**62), (BASE + 500_000, BASE + 700_000)):
                got, want = selective(p, shard, pick, lo, hi), selective(j, shard, pick, lo, hi)
                assert got == want and got
                assert p.stats_selective_bytes == j.stats_selective_bytes
        full = sum(len(b) for n, b in tree_files(shard_dir(root, shard)).items()
                   if n.startswith("chunks-"))
        one = PC.LocalColumnStore(root)
        selective(one, shard, tags[:1])
        assert 0 < one.stats_selective_bytes < full


def test_torn_manifest_line_keeps_later_appends_visible(flushed, tmp_path):
    root = copy_tree(flushed["roots"]["port"], tmp_path / "torn")
    tags = shard_tags(flushed, 0)
    mpath = os.path.join(shard_dir(root), "manifest.jsonl")
    with open(mpath, "ab") as f:
        f.write(b'{"pk": "00ab", "seg": "chunks-g0.se')  # a crash mid-line
    assert PC.torn_final_line(mpath) and JC.torn_final_line(mpath)
    new_tags = {S.METRIC_TAG: "late_metric", "instance": "x"}
    ms = port_store()
    sh = ms.shard(DS, 0)
    sh.ingest_series(SeriesBatch(S.GAUGE, new_tags, BASE + np.arange(70, dtype=np.int64) * 1000,
                                 {"value": np.arange(70.0)}))
    store = PC.LocalColumnStore(root)
    PF.FlushCoordinator(ms, store).flush_shard(DS, 0)
    for cls in (PC.LocalColumnStore, JC.LocalColumnStore):
        s = cls(root)
        assert len(selective(s, 0, [new_tags])) == 2  # 64 + 6 samples
        assert selective(s, 0, tags) == selective(PC.LocalColumnStore(flushed["roots"]["port"]),
                                                  0, tags)


def test_truncated_segment_reads_as_the_jax_package_reads_it(flushed, tmp_path):
    root = copy_tree(flushed["roots"]["port"], tmp_path / "trunc")
    seg = sorted(f for f in os.listdir(shard_dir(root)) if f.startswith("chunks-"))[0]
    path = os.path.join(shard_dir(root), seg)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 37)  # a crash mid-append
    got = [(h["start"], h["n"]) for h, _, _ in PC.LocalColumnStore(root).read_chunks(DS, 0)]
    want = [(h["start"], h["n"]) for h, _, _ in JC.LocalColumnStore(root).read_chunks(DS, 0)]
    assert got == want
    full = [(h["start"], h["n"]) for h, _, _ in
            PC.LocalColumnStore(flushed["roots"]["port"]).read_chunks(DS, 0)]
    assert len(got) == len(full) - 1
    pms, _ = recovered(root, "port")
    jms, _ = recovered(root, "jax")
    assert sum(c.n for p in pms.shard(DS, 0).partitions.values() for c in p.chunks) == sum(
        c.n for p in jms.shard(DS, 0).partitions.values() for c in p.chunks)


def test_manifest_backfill_and_repair_match_jax(flushed, tmp_path):
    roots = {k: copy_tree(flushed["roots"]["port"], tmp_path / k) for k in ("port", "jax")}
    for k in roots:
        os.remove(os.path.join(shard_dir(roots[k]), "manifest.jsonl"))
    tags = shard_tags(flushed, 0)
    # a write to a shard without a manifest backfills it first
    for k, cls in (("port", PC.LocalColumnStore), ("jax", JC.LocalColumnStore)):
        pms, _ = recovered(flushed["roots"]["port"], "port")
        st = cls(roots[k])
        sh = pms.shard(DS, 0)
        chunk_owner = next(p for p in sh.partitions.values() if p.chunks)
        st.write_chunks(DS, 0, 3, chunk_owner.part_id, chunk_owner.tags, chunk_owner.schema,
                        chunk_owner.chunks[:1])
    m = {k: open(os.path.join(shard_dir(r), "manifest.jsonl"), "rb").read()
         for k, r in roots.items()}
    assert m["port"] == m["jax"] and m["port"]
    # frames appended behind the manifest's back are re-indexed on read
    for k in roots:
        extra = os.path.join(shard_dir(roots[k]), "chunks-g0.seg")
        src = os.path.join(shard_dir(flushed["roots"]["port"]), "chunks-g0.seg")
        with open(src, "rb") as f, open(extra, "ab") as g:
            g.write(f.read())
    got = selective(PC.LocalColumnStore(roots["port"]), 0, tags)
    want = selective(JC.LocalColumnStore(roots["jax"]), 0, tags)
    assert got == want
    assert open(os.path.join(shard_dir(roots["port"]), "manifest.jsonl"), "rb").read() == open(
        os.path.join(shard_dir(roots["jax"]), "manifest.jsonl"), "rb").read()


def test_racing_flushes_never_write_a_chunk_twice(tmp_path):
    data = make_data("irregular", seed=5)
    pms = port_store(16)
    store = PC.LocalColumnStore(str(tmp_path))
    coord = PF.FlushCoordinator(pms, store)
    half = len(data[0][2]) // 2
    ingest(pms, None, [(t, s, ts[:half], v[:half]) for t, s, ts, v in data])
    barrier = threading.Barrier(4)
    results = []

    def flush():
        barrier.wait()
        results.append(coord.flush_all(DS))

    threads = [threading.Thread(target=flush) for _ in range(3)]
    for t in threads:
        t.start()
    barrier.wait()
    ingest(pms, None, [(t, s, ts[half:], v[half:]) for t, s, ts, v in data])
    for t in threads:
        t.join()
    results.append(coord.flush_all(DS))
    frames = [(json_key(h), h["start"]) for s in range(N_SHARDS)
              for h, _, _ in store.read_chunks(DS, s)]
    assert len(frames) == len(set(frames)) == sum(r.chunks_written for r in results)
    persisted = sum(h["n"] for s in range(N_SHARDS) for h, _, _ in store.read_chunks(DS, s))
    assert persisted == sum(len(ts) for _, _, ts, _ in data)


def json_key(header) -> str:
    import json

    return json.dumps(header["tags"], sort_keys=True)


def test_chunkmeta_encoded_bytes_match_jax(flushed):
    """Flushed chunks carry their encoded form: ``_filodb_chunkmeta_all``
    reports its size as the JAX package does."""
    q = "_filodb_chunkmeta_all(http_requests_total)"
    want = JaxEngine(flushed["jms"], DS).query_range(q, START_S, END_S, STEP_S).metadata
    got = QueryEngine(flushed["pms"], DS, device="cpu").query_range(
        q, START_S, END_S, STEP_S).metadata
    assert got == want
    assert all(c["encodedBytes"] > 0 for r in got for c in r["chunks"])


@pytest.fixture(scope="module")
def hist_flushed(tmp_path_factory):
    jb = histogram_batch(n_series=8, n_samples=150, start_ms=BASE, metric="http_request_latency")
    jms, pms = jax_store(), port_store()
    jms.ingest_routed(DS, jb, SPREAD)
    pms.ingest_routed(DS, RecordBatch(S.SCHEMAS[jb.schema.name], jb.timestamps, dict(jb.values),
                                      jb.tags, bucket_les=jb.bucket_les), SPREAD)
    root = str(tmp_path_factory.mktemp("hist"))
    PF.FlushCoordinator(pms, PC.LocalColumnStore(root)).flush_all(DS)
    return {"root": root, "jms": jms, "pms": pms}


HIST_QUERIES = ("sum(rate(http_request_latency[5m]))",
                "histogram_quantile(0.9, sum(rate(http_request_latency[5m])))",
                "rate(http_request_latency_sum[5m])")


def answer(engine, query):
    try:
        res = engine.query_range(query, START_S, END_S, STEP_S)
    except Exception as e:  # noqa: BLE001 -- the outcome compared is the exception
        return ("raised", type(e).__name__)
    out = {}
    for g in res.grids:
        h = g.hist_np() if g.hist is not None else None
        for i, lab in enumerate(g.labels):
            key = tuple(sorted(lab.items()))
            out[key] = (np.asarray(g.values_np()[i], np.float64),
                        None if h is None else np.asarray(h[i], np.float64))
    return ("answered", out)


@pytest.mark.parametrize("query", HIST_QUERIES)
def test_recovered_native_histograms_answer_as_jax(hist_flushed, query):
    """No bucket bounds are persisted: a recovered native-histogram store
    has none in either package (ROADMAP C), and the port answers what the
    JAX package answers over it."""
    pms, _ = recovered(hist_flushed["root"], "port")
    jms, _ = recovered(hist_flushed["root"], "jax")
    for ms in (pms, jms):
        parts = [p for s in range(N_SHARDS) for p in ms.shard(DS, s).partitions.values()]
        assert parts and all(p.schema.name == "prom-histogram" and p.bucket_les is None
                             for p in parts)
    got = answer(QueryEngine(pms, DS, device="cpu"), query)
    want = answer(JaxEngine(jms, DS), query)
    assert got[0] == want[0], (got, want)
    if got[0] == "raised":
        assert got == want
        return
    assert sorted(got[1]) == sorted(want[1])
    for k, (wv, wh) in want[1].items():
        gv, gh = got[1][k]
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
        np.testing.assert_allclose(gv[~np.isnan(wv)], wv[~np.isnan(wv)], rtol=2e-4, atol=1e-4)
        assert (gh is None) == (wh is None)
        if wh is not None:
            np.testing.assert_allclose(gh, wh, rtol=2e-4, atol=1e-4, equal_nan=True)
