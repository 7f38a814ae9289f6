"""The port's standalone server (counterpart of ``filodb_tpu/server.py``;
reference L7 NewFiloServerMain.scala:25): a memory-only store of
``shards`` shards, a ``QueryEngine`` on the card (or the CPU when asked)
and the Prometheus HTTP API (``api/http.py``).

Config is the JSON dict of ``config.py``, e.g.::

    {"dataset": "prometheus", "shards": 8, "spread": 3, "http_port": 9090,
     "device": null}

``device`` null (the default) serves on the card and raises where there is
none; ``"cpu"`` serves on the CPU. A config that asks for a subsystem the
port has not got raises ``NotImplementedError`` naming its ROADMAP item
(``unported_settings``): persistence and flush (A4), scheduling, standing
queries and coalescing (A5), self-telemetry, SLOs and alerting (A6),
downsampling and pre-aggregation (A7), the device index tier (A8), the
cluster and gRPC (A9). The JAX defaults that turn such subsystems on by
themselves are off in the port (``config.PORT_OFF``).
"""

from __future__ import annotations

import json
import logging
import threading

from .api.http import serve_background
from .coordinator.planner import PlannerParams, QueryEngine, resolve_device
from .core.schemas import Dataset
from .memstore.memstore import TimeSeriesMemStore
from .memstore.shard import StoreConfig

log = logging.getLogger("filodb_tpu_torch.server")


def unported_settings(cfg: dict) -> list[str]:
    """The settings of ``cfg`` that ask for a subsystem the port has not
    got, each with its ROADMAP item."""
    q, dist = cfg["query"], cfg.get("distributed") or {}
    checks = [
        (cfg.get("store_root"), "store_root: persistence and flush (ROADMAP A4)"),
        (cfg.get("quotas"), "quotas: cardinality quotas (ROADMAP A4)"),
        (cfg.get("index_backend", "python") != "python",
         "index_backend: the part-key index at scale (ROADMAP A4)"),
        (cfg.get("index_device_postings"), "index_device_postings: the device index tier "
         "(ROADMAP A8)"),
        (int(q.get("parallelism", 0) or 0) > 0, "query.parallelism: the query scheduler "
         "(ROADMAP A5)"),
        (float(q.get("batch_window_ms", 0) or 0) > 0, "query.batch_window_ms: cross-query "
         "batching (ROADMAP A5)"),
        (q.get("tenant_quotas") or int(q.get("admission_max_queued", 0) or 0),
         "query.tenant_quotas/admission_max_queued: admission control (ROADMAP A5)"),
        ((q.get("prewarm") or {}).get("enabled"), "query.prewarm: executable pre-warm "
         "(ROADMAP A5)"),
        ((cfg.get("standing") or {}).get("enabled"), "standing: standing queries "
         "(ROADMAP A5)"),
        ((cfg.get("telemetry") or {}).get("self_scrape_interval_s"),
         "telemetry.self_scrape_interval_s: self-telemetry (ROADMAP A6)"),
        ((cfg.get("slo") or {}).get("enabled"), "slo: SLO burn-rate rules (ROADMAP A6)"),
        ((cfg.get("alerting") or {}).get("enabled"), "alerting: the alerting plane "
         "(ROADMAP A6)"),
        ((cfg.get("profiler") or {}).get("enabled"), "profiler: the sampling profiler "
         "(ROADMAP A6)"),
        ((cfg.get("downsample") or {}).get("enabled"), "downsample: downsampling "
         "(ROADMAP A7)"),
        (cfg.get("preagg_rules"), "preagg_rules: pre-aggregation (ROADMAP A7)"),
        ((cfg.get("rollup") or {}).get("enabled"), "rollup: the sketch rollup tier "
         "(ROADMAP A7)"),
        (any(dist.get(k) for k in ("coordinator", "num_processes", "process_id", "peers",
                                   "owned_shards", "seeds", "advertise_url")),
         "distributed: peers and shard ownership (ROADMAP A9)"),
        (cfg.get("grpc_port") is not None, "grpc_port: the gRPC RemoteExec service "
         "(ROADMAP A9)"),
        ((cfg.get("result_plane") or {}).get("peer_exchange") == "arrow",
         "result_plane.peer_exchange=arrow: the Arrow edge (needs pyarrow; ROADMAP A3)"),
    ]
    return [why for asked, why in checks if asked]


class FiloServer:
    """A memory-only server: ``start`` serves the HTTP API on a thread and
    runs the maintenance loop; ``stop`` ends both."""

    def __init__(self, config: dict | None = None, device=None):
        from .config import load_config

        cfg = load_config(overrides=config or {})
        missing = unported_settings(cfg)
        if missing:
            raise NotImplementedError("not ported to filodb_tpu_torch yet: "
                                      + "; ".join(missing))
        self.config = cfg
        self.device = resolve_device(device if device is not None else cfg.get("device"))
        self.dataset = cfg["dataset"]
        self.n_shards = int(cfg["shards"])
        self.spread = int(cfg["spread"])
        self.http_port = int(cfg["http_port"])
        self.maintenance_interval_s = min(float(cfg["flush_interval_s"]), 60.0)
        self.store_config = StoreConfig(
            max_chunk_size=int(cfg["max_chunk_size"]),
            max_partitions=int(cfg["max_partitions_per_shard"]),
        )
        self.memstore = TimeSeriesMemStore(self.store_config)
        self.memstore.setup(Dataset(self.dataset), range(self.n_shards),
                            total_shards=self.n_shards)
        q = cfg["query"]
        slow = q.get("slow_query_threshold_s")
        from .metrics import SLOW_QUERY_LOG

        SLOW_QUERY_LOG.configure(int(q.get("slow_query_log_max", 64) or 64))
        self.engine = QueryEngine(
            self.memstore, self.dataset,
            PlannerParams(
                spread=self.spread, lookback_ms=int(q["lookback_ms"]),
                max_series=int(q["max_series"]), deadline_s=float(q["timeout_s"]),
                num_shards=self.n_shards, fused_aggregate=bool(q.get("fused_aggregate", True)),
                allow_partial_results=bool(q.get("allow_partial_results", False)),
                slow_query_threshold_s=float(slow) if slow is not None else None,
            ),
            device=self.device,
        )
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._http = None

    def start(self, port: int | None = None) -> int:
        """Serve the HTTP API (``port`` 0: any free port) and start the
        maintenance loop; returns the port."""
        self._http, actual = serve_background(
            self.engine, host=self.config.get("http_host") or "127.0.0.1",
            port=self.http_port if port is None else port,
            auth_token=self.config.get("http_auth_token"),
            result_plane=self.config.get("result_plane"))
        t = threading.Thread(target=self._maintenance_loop, daemon=True,
                             name="filodb-maintenance")
        t.start()
        self._threads.append(t)
        log.info("filodb_tpu_torch serving on :%d (%d shards, %s)", actual, self.n_shards,
                 self.device)
        return actual

    def stop(self) -> None:
        self._stop.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _maintenance_loop(self) -> None:
        """Refresh the device ledger's gauges every interval, so
        ``filodb_device_bytes`` stays current between scrapes. Flush and
        retention eviction come with persistence (ROADMAP A4)."""
        from .ledger import LEDGER

        while not self._stop.wait(self.maintenance_interval_s):
            try:
                LEDGER.publish()
            except Exception:  # noqa: BLE001 -- the loop must outlive a bad tick
                log.exception("ledger refresh failed")


def main(argv=None):
    import argparse
    import time

    p = argparse.ArgumentParser("filodb-tpu-torch-server")
    p.add_argument("--config", help="JSON config file")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cpu to serve on the CPU; the default is the card")
    args = p.parse_args(argv)
    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    logging.basicConfig(level=logging.INFO)
    srv = FiloServer(cfg, device=args.device)
    port = srv.start(port=args.port)
    print(f"listening on :{port} ({srv.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
