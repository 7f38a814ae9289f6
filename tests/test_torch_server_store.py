"""The port's server with a column store, on the CPU, against the JAX
package: ``store_root`` and ``quotas`` are served, not refused; ingest,
``POST /admin/flush``, stop, and a new server on the same root recovers and
answers ``query_range`` as before; the maintenance loop flushes by itself;
``/ingest/prom`` keeps OpenMetrics exemplars and ``/api/v1/query_exemplars``
answers the JAX handler's JSON; ``/admin/flush`` answers as the JAX
handler's; ``FiloClient.exemplars``; and the CLI's ``copy-store`` and
``cardbust`` write what the JAX CLI writes."""

import json
import os
import shutil
import subprocess
import sys
import time
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from filodb_tpu.api import http as JHTTP
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.store import columnstore as JC
from filodb_tpu.store import flush as JF
from filodb_tpu_torch.api import http as HTTP
from filodb_tpu_torch.client import FiloClient
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.memstore.cardinality import QuotaExceededError
from filodb_tpu_torch.server import FiloServer
from filodb_tpu_torch.store import columnstore as PC
from filodb_tpu_torch.store import flush as PF
from test_torch_http import get
from test_torch_persistence import DS, N_SHARDS, ingest, jax_store, port_store, tree_files
from test_torch_tree import BASE, make_data

ROOT = Path(__file__).resolve().parents[1]
KEEP = {"retention_hours": 10**7}  # the seeded data is from 2020: keep it


def exposition(n_series=6, n=40, exemplars=True) -> str:
    rng = np.random.default_rng(21)
    lines = ["# TYPE store_requests_total counter"]
    for i in range(n_series):
        v = np.cumsum(rng.uniform(0, 5, n))
        for k in range(n):
            line = (f'store_requests_total{{instance="s{i}",zone="z{i % 3}"}} {float(v[k])!r} '
                    f"{BASE + k * 15_000}")
            if exemplars and k % 10 == 3:
                line += f' # {{trace_id="t{i}-{k}"}} {0.25 * k} {(BASE + k * 15_000) / 1000}'
            lines.append(line)
    return "\n".join(lines) + "\n"


def range_path(q: str, lo=(BASE + 300_000) / 1e3, hi=(BASE + 580_000) / 1e3, step=30):
    return f"/api/v1/query_range?query={urllib.parse.quote(q)}&start={lo}&end={hi}&step={step}"


def body(base, path, data=None):
    status, _, raw = get(base, path, data)
    assert status == 200, raw
    return json.loads(raw)


def answer(base, path):
    """A query's answer without ``stats.kernelSeconds``: the host wall of
    its launches, which differs from run to run."""
    out = body(base, path)
    out["data"].get("stats", {}).pop("kernelSeconds", None)
    return out


def test_store_root_and_quotas_are_served(tmp_path):
    srv = FiloServer(dict(KEEP, store_root=str(tmp_path), shards=2,
                          quotas=[{"prefix": ["demo"], "quota": 1}]), device="cpu")
    assert isinstance(srv.column_store, PC.LocalColumnStore)
    assert all(sh.odp_store is srv.column_store for sh in srv.memstore.shards("prometheus"))
    assert all(sh.cardinality.quota_of(("demo",)) == 1 for sh in srv.memstore.shards("prometheus"))
    assert srv.store_config.retention_ms == 10**7 * 3_600_000
    memory_only = FiloServer({"shards": 2}, device="cpu")
    assert isinstance(memory_only.column_store, PC.NullColumnStore)
    assert all(sh.odp_store is None for sh in memory_only.memstore.shards("prometheus"))
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import GAUGE

    sh = srv.memstore.shard("prometheus", 0)
    ts = BASE + np.arange(3, dtype=np.int64)
    sh.ingest_series(SeriesBatch(GAUGE, {"_ws_": "demo", "_metric_": "a"}, ts,
                                 {"value": np.ones(3)}))
    with pytest.raises(QuotaExceededError):
        sh.ingest_series(SeriesBatch(GAUGE, {"_ws_": "demo", "_metric_": "b"}, ts,
                                     {"value": np.ones(3)}))


def test_the_server_tunes_its_heap():
    """Where the C library is glibc, ``tune_heap`` holds its trimming off
    (``mallopt`` answers 1); elsewhere it reports False."""
    import platform

    from filodb_tpu_torch import server

    assert server.tune_heap() is (platform.libc_ver()[0] == "glibc")


def test_flush_stop_and_recover_answer_the_same(tmp_path):
    cfg = dict(KEEP, store_root=str(tmp_path), shards=4)
    queries = ("sum by (zone) (rate(store_requests_total[2m]))", "store_requests_total")
    srv = FiloServer(cfg, device="cpu")
    base = f"http://127.0.0.1:{srv.start(port=0)}"
    try:
        assert body(base, "/ingest/prom", exposition().encode())["data"] == {"ingested": 240}
        before = {q: answer(base, range_path(q)) for q in queries}
        flushed = body(base, "/admin/flush", b"")["data"]
        assert flushed == {"chunks_written": 6, "partkeys_written": 6}
        assert body(base, "/admin/flush", b"")["data"] == {"chunks_written": 0,
                                                          "partkeys_written": 0}
    finally:
        srv.stop()
    again = FiloServer(cfg, device="cpu")
    base = f"http://127.0.0.1:{again.start(port=0)}"
    try:
        for q in queries:
            assert answer(base, range_path(q)) == before[q], q
        parts = [p for sh in again.memstore.shards("prometheus") for p in sh.partitions.values()]
        assert len(parts) == 6 and all(p.flushed_until > 0 for p in parts)
    finally:
        again.stop()


def test_the_maintenance_loop_flushes(tmp_path):
    srv = FiloServer(dict(KEEP, store_root=str(tmp_path), shards=2, flush_interval_s=0.05),
                     device="cpu")
    base = f"http://127.0.0.1:{srv.start(port=0)}"
    try:
        body(base, "/ingest/prom", exposition(exemplars=False).encode())
        deadline = time.time() + 30
        while time.time() < deadline and not srv.memstore.shard("prometheus", 0).stats.chunks_flushed:
            time.sleep(0.05)
    finally:
        srv.stop()
    n = sum(h["n"] for s in range(2) for h, _, _ in srv.column_store.read_chunks("prometheus", s))
    assert n == 240


@pytest.fixture
def both_servers():
    """The JAX handler and the port's over mirrored stores, each with its
    package's flush over its own column store."""
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    pms, jms = port_store(), jax_store()
    ingest(pms, jms, make_data("regular", seed=12))
    pflush = PF.FlushCoordinator(pms, PC.LocalColumnStore(str(tmp / "p")))
    jflush = JF.FlushCoordinator(jms, JC.LocalColumnStore(str(tmp / "j")))
    jsrv, jport = JHTTP.serve_background(JaxEngine(jms, DS), port=0,
                                         flush_hook=lambda: jflush.flush_all(DS))
    psrv, pport = HTTP.serve_background(QueryEngine(pms, DS, device="cpu"), port=0,
                                        flush_hook=lambda: pflush.flush_all(DS))
    yield {"jax": f"http://127.0.0.1:{jport}", "port": f"http://127.0.0.1:{pport}",
           "root": tmp}
    for srv in (jsrv, psrv):
        srv.shutdown()
        srv.server_close()
    shutil.rmtree(tmp)


def test_exemplars_and_flush_answer_as_the_jax_handler(both_servers):
    text = exposition().encode()
    for k in ("jax", "port"):
        assert body(both_servers[k], "/ingest/prom", text)["data"] == {"ingested": 240}
    for q, lo, hi in (("store_requests_total", None, None),
                      ('store_requests_total{zone="z1"}', BASE / 1e3 + 100, BASE / 1e3 + 400),
                      ("sum(rate(store_requests_total[5m]))", None, None),
                      ("no_such_metric", None, None)):
        path = f"/api/v1/query_exemplars?query={urllib.parse.quote(q)}"
        if lo is not None:
            path += f"&start={lo}&end={hi}"
        want, got = (get(both_servers[k], path) for k in ("jax", "port"))
        assert got[0] == want[0] == 200
        assert json.loads(got[2]) == json.loads(want[2]), q
    missing = [get(both_servers[k], "/api/v1/query_exemplars") for k in ("jax", "port")]
    assert missing[0][0] == missing[1][0] == 400
    assert json.loads(missing[0][2]) == json.loads(missing[1][2])
    ex = FiloClient(both_servers["port"], timeout=30).exemplars(
        "store_requests_total", BASE / 1e3, BASE / 1e3 + 1000)
    assert len(ex) == 6 and all(len(s["exemplars"]) == 4 for s in ex)
    flushes = [get(both_servers[k], "/admin/flush", b"") for k in ("jax", "port")]
    assert flushes[0][0] == flushes[1][0] == 200
    assert json.loads(flushes[0][2]) == json.loads(flushes[1][2])
    root = both_servers["root"]
    assert tree_files(root / "p") == tree_files(root / "j")


def test_flush_without_a_flusher_answers_404(both_servers):
    from filodb_tpu_torch.ops import staging as ST  # noqa: F401 -- the port's engine needs it

    pms = port_store()
    srv, port = HTTP.serve_background(QueryEngine(pms, DS, device="cpu"), port=0)
    try:
        status, _, raw = get(f"http://127.0.0.1:{port}", "/admin/flush", b"")
        assert status == 404 and json.loads(raw)["errorType"] == "not_found"
        status, _, _ = get(f"http://127.0.0.1:{port}", "/admin/flush")
        assert status == 404  # a GET is no flush
    finally:
        srv.shutdown()
        srv.server_close()


def flushed_store(tmp_path) -> Path:
    pms = port_store()
    ingest(pms, None, make_data("irregular", seed=13))
    root = tmp_path / "src"
    PF.FlushCoordinator(pms, PC.LocalColumnStore(str(root))).flush_all(DS)
    return root


def cli(package: str, *args) -> dict:
    out = subprocess.run([sys.executable, "-m", f"{package}.cli", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu", FILODB_PLATFORM="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def test_copy_store_writes_what_the_jax_cli_writes(tmp_path):
    src = flushed_store(tmp_path)
    got = cli("filodb_tpu_torch", "copy-store", "--src", str(src), "--dst", str(tmp_path / "p"))
    want = cli("filodb_tpu", "copy-store", "--src", str(src), "--dst", str(tmp_path / "j"))
    assert got == want and got["chunks_copied"] > 0
    assert tree_files(tmp_path / "p") == tree_files(tmp_path / "j")


@pytest.mark.parametrize("selector", ['node_temp{instance="host-1"}', "http_requests_total",
                                      '{zone=~"z[01]"}', "no_such_metric"])
def test_cardbust_writes_what_the_jax_cli_writes(tmp_path, selector):
    src = flushed_store(tmp_path)
    p, j = shutil.copytree(src, tmp_path / "p"), shutil.copytree(src, tmp_path / "j")
    got = cli("filodb_tpu_torch", "cardbust", "--store", str(p), selector)
    want = cli("filodb_tpu", "cardbust", "--store", str(j), selector)
    assert got == want
    assert tree_files(p) == tree_files(j)
    left = {json.dumps(r["tags"], sort_keys=True) for s in range(N_SHARDS)
            for r in PC.LocalColumnStore(str(p)).read_partkeys(DS, s)}
    assert len(left) == 16 - got["series_deleted"]
