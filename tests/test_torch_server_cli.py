"""The port's server, CLI, client and device ledger on the CPU: ``load_config``
against the JAX package's (equal on the shared keys except the defaults
the port holds off, ``config.PORT_OFF``); ``FiloServer(device="cpu")``
booting and answering, ``FiloServer()`` raising without a card, each
unported setting raising with its ROADMAP item; ``cli serve --device cpu``
in a subprocess answering ``cli ingest-csv`` and ``cli query-range`` as
the JAX CLI does against a JAX server on the same rows; ``FiloClient``
against both servers; and the ledger's drift at 0 after queries and
evictions."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from filodb_tpu.api import http as JHTTP
from filodb_tpu.config import load_config as jax_load_config
from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core.schemas import Dataset as JaxDataset
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu_torch.client import FiloClient
from filodb_tpu_torch.config import DEFAULTS, PORT_OFF, load_config
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.ledger import LEDGER
from filodb_tpu_torch.server import FiloServer
from tests.test_torch_engine import END_S, START_S, STEP_S, build_stores, make_data

ROOT = Path(__file__).resolve().parents[1]
BASE = 1_600_000_000_000


def flat(d: dict, prefix=()) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and v:
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_load_config_equals_jax_on_shared_keys(tmp_path):
    override = {"shards": 4, "query": {"lookback_ms": 60_000}, "http_port": 1234}
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"spread": 1, "query": {"timeout_s": 5}}))
    port = flat(load_config(str(cfg_file), override))
    jax = flat(jax_load_config(str(cfg_file), override))
    off = {path: value for path, value, _ in PORT_OFF}
    shared = set(port) & set(jax)
    assert set(jax) - shared == {("compile_cache_dir",)}
    assert set(port) - shared == {("device",)} and port[("device",)] is None
    for key in shared:
        assert port[key] == (off[key] if key in off else jax[key]), key
    assert port[("query", "timeout_s")] == 5 and port[("spread",)] == 1
    assert all(jax[k] != v for k, v in off.items())  # each one a real difference
    assert load_config() == load_config() and load_config() is not DEFAULTS


def http_get(base: str, path: str, data: bytes | None = None):
    import urllib.request

    req = urllib.request.Request(base + path, data=data, method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def counter_lines(n_series=6, n=40):
    rng = np.random.default_rng(11)
    rows = []
    for i in range(n_series):
        v = np.cumsum(rng.uniform(0, 5, n))
        rows += [("cli_requests_total", f"instance=c{i};zone=z{i % 3}", BASE + k * 15_000,
                  float(v[k])) for k in range(n)]
    return rows


def test_server_on_the_cpu_boots_and_answers():
    srv = FiloServer({"shards": 2, "flush_interval_s": 0.05}, device="cpu")
    port = srv.start(port=0)
    try:
        base = f"http://127.0.0.1:{port}"
        assert http_get(base, "/admin/health") == {"status": "healthy", "shards": 2}
        body = "\n".join(json.dumps({"tags": {"__name__": "room_temp", "room": f"r{i}"},
                                     "ts_ms": BASE + k * 15_000, "value": 20.0 + i})
                         for i in range(3) for k in range(40)).encode()
        assert http_get(base, "/ingest", body)["data"] == {"ingested": 120}
        res = http_get(base, f"/api/v1/query?query=sum(room_temp)&time={(BASE + 500_000) / 1e3}")
        assert res["data"]["result"][0]["value"][1] == "63.0"
        time.sleep(0.2)  # the maintenance loop ticks
        assert srv.engine.device == torch.device("cpu")
    finally:
        srv.stop()


def test_server_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FiloServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FiloServer({"device": None})


UNPORTED_CONFIGS = [
    ({"store_root": "/nowhere"}, "A4"),
    ({"quotas": [{"prefix": ["a"], "quota": 1}]}, "A4"),
    ({"index_backend": "native"}, "A4"),
    ({"index_device_postings": True}, "A8"),
    ({"query": {"parallelism": 4}}, "A5"),
    ({"query": {"batch_window_ms": 2.0}}, "A5"),
    ({"query": {"tenant_quotas": {"*": {"rate": 1}}}}, "A5"),
    ({"query": {"prewarm": {"enabled": True}}}, "A5"),
    ({"standing": {"enabled": True}}, "A5"),
    ({"telemetry": {"self_scrape_interval_s": 10}}, "A6"),
    ({"slo": {"enabled": True}}, "A6"),
    ({"alerting": {"enabled": True}}, "A6"),
    ({"profiler": {"enabled": True}}, "A6"),
    ({"downsample": {"enabled": True}}, "A7"),
    ({"preagg_rules": [{"metric_regex": ".*", "include_tags": ["a"]}]}, "A7"),
    ({"rollup": {"enabled": True}}, "A7"),
    ({"distributed": {"peers": ["http://x"]}}, "A9"),
    ({"grpc_port": 0}, "A9"),
    ({"result_plane": {"peer_exchange": "arrow"}}, "A3"),
]


@pytest.mark.parametrize("config,item", UNPORTED_CONFIGS,
                         ids=[next(iter(c)) + "-" + i for c, i in UNPORTED_CONFIGS])
def test_unported_settings_raise(config, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        FiloServer(config, device="cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli(package: str, *args, env=None) -> dict:
    out = subprocess.run([sys.executable, "-m", f"{package}.cli", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """The port's ``cli serve --device cpu`` in a subprocess and a JAX server
    in this process, both given the same CSV through their own
    ``cli ingest-csv``."""
    port = free_port()
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-m", "filodb_tpu_torch.cli", "serve", "--device",
                             "cpu", "--port", str(port)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    ready = threading.Event()
    lines = []

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("listening on"):
                ready.set()

    threading.Thread(target=drain, daemon=True).start()
    jms = JaxMemStore()
    jms.setup(JaxDataset("prometheus"), range(8))
    jsrv, jport = JHTTP.serve_background(JaxEngine(jms, "prometheus", JaxParams(num_shards=8)),
                                         port=0)
    try:
        assert ready.wait(120), "".join(lines)[-2000:]
        urls = {"port": f"http://127.0.0.1:{port}", "jax": f"http://127.0.0.1:{jport}"}
        csv = tmp_path_factory.mktemp("csv") / "rows.csv"
        csv.write_text("".join(f"{m},{t},{ts},{v!r}\n" for m, t, ts, v in counter_lines()))
        for pkg, url in (("filodb_tpu_torch", urls["port"]), ("filodb_tpu", urls["jax"])):
            assert cli(pkg, "ingest-csv", str(csv), "--host", url)["data"] == {"ingested": 240}
        yield urls
    finally:
        jsrv.shutdown()
        jsrv.server_close()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_query_range_answers_as_jax(both_servers):
    args = ("query-range", "sum by (zone) (rate(cli_requests_total[2m]))", "--start",
            str((BASE + 200_000) / 1e3), "--end", str((BASE + 580_000) / 1e3), "--step", "30")
    got = cli("filodb_tpu_torch", *args, "--host", both_servers["port"])
    want = cli("filodb_tpu", *args, "--host", both_servers["jax"])
    g = {json.dumps(r["metric"], sort_keys=True): r["values"] for r in got["data"]["result"]}
    w = {json.dumps(r["metric"], sort_keys=True): r["values"] for r in want["data"]["result"]}
    assert sorted(g) == sorted(w) and len(w) == 3
    for k, vals in w.items():
        assert [t for t, _ in g[k]] == [t for t, _ in vals]
        np.testing.assert_allclose([float(v) for _, v in g[k]], [float(v) for _, v in vals],
                                   rtol=2e-4, atol=1e-4)
    for sub in (("labels",), ("label-values", "zone"), ("series", "cli_requests_total")):
        got = cli("filodb_tpu_torch", *sub, "--host", both_servers["port"])["data"]
        want = cli("filodb_tpu", *sub, "--host", both_servers["jax"])["data"]
        key = lambda x: json.dumps(x, sort_keys=True)  # noqa: E731
        assert sorted(got, key=key) == sorted(want, key=key), sub
    partkey = 'cli_requests_total{instance="c1"}'
    assert cli("filodb_tpu_torch", "partkey", partkey) == cli("filodb_tpu", "partkey", partkey)


def test_cli_store_tools_raise_with_their_roadmap_item():
    out = subprocess.run([sys.executable, "-m", "filodb_tpu_torch.cli", "copy-store", "--src",
                          "a", "--dst", "b"], cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode != 0 and "ROADMAP A4" in out.stderr


def test_client_against_both_servers(both_servers):
    clients = {k: FiloClient(url, timeout=30) for k, url in both_servers.items()}
    q = "max by (zone) (rate(cli_requests_total[2m]))"
    answers = {k: c.query_range(q, (BASE + 200_000) / 1e3, (BASE + 580_000) / 1e3, 30)
               for k, c in clients.items()}
    (t_p, s_p), (t_j, s_j) = answers["port"], answers["jax"]
    np.testing.assert_array_equal(t_p, t_j)
    by = {k: {json.dumps(r["metric"], sort_keys=True): r["values"] for r in s}
          for k, s in (("port", s_p), ("jax", s_j))}
    assert sorted(by["port"]) == sorted(by["jax"])
    for k, v in by["jax"].items():
        np.testing.assert_array_equal(np.isnan(by["port"][k]), np.isnan(v))
        np.testing.assert_allclose(by["port"][k][~np.isnan(v)], v[~np.isnan(v)], rtol=2e-4)
    assert clients["port"].labels() == clients["jax"].labels()
    assert clients["port"].label_values("zone") == clients["jax"].label_values("zone")
    assert clients["port"].metadata() == clients["jax"].metadata()
    assert clients["port"].health()["status"] == clients["jax"].health()["status"]
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        FiloClient(both_servers["port"], grpc_endpoint="grpc://127.0.0.1:1")


def test_ledger_drift_is_zero_after_queries_and_evictions():
    """Small caches (one superblock, a staging budget of a few blocks) under
    queries of several selections: entries are evicted and replaced, and
    every account's balance equals a cold walk of its cache."""
    from filodb_tpu_torch.ops import staging as ST

    _, pms = build_stores(make_data("irregular", seed=8))
    for sh in pms.shards("prometheus"):
        sh.config.stage_cache_bytes = 60_000
    pms._superblock_cache = ST.SuperblockCache(max_entries=1)
    engine = QueryEngine(pms, "prometheus", device="cpu")
    for q in ("sum(rate(http_requests_total[5m]))", "sum(max_over_time(node_temp[5m]))",
              "rate(http_requests_total[5m])", "sum(rate(http_requests_total[10m]))",
              "node_temp", "sum(rate(http_requests_total[5m]))"):
        engine.query_range(q, START_S, END_S, STEP_S)
    verify = LEDGER.verify()
    assert all(k["drift"] == 0 for k in verify["kinds"].values()), verify["kinds"]
    mine = [a for a in verify["accounts"] if a["name"].startswith("prometheus/shard-")
            or a["name"] == "superblock_cache"]
    assert mine and sum(a["frees"] for a in mine) > 0
    cache = pms._superblock_cache
    assert len(cache) == 1 and cache.ledger.bytes == cache._walk() > 0
    balances = LEDGER.balances()
    assert balances["superblock"] >= cache.ledger.bytes
