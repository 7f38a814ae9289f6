"""The port's standalone server (counterpart of ``filodb_tpu/server.py``;
reference L7 NewFiloServerMain.scala:25): a store of ``shards`` shards,
recovered from its column store at start, a ``QueryEngine`` on the card
(or the CPU when asked), the Prometheus HTTP API (``api/http.py``) and a
maintenance loop that flushes every ``flush_interval_s`` and evicts by
retention and headroom.

Config is the JSON dict of ``config.py``, e.g.::

    {"dataset": "prometheus", "shards": 8, "spread": 3, "http_port": 9090,
     "store_root": "/var/lib/filodb", "flush_interval_s": 3600,
     "retention_hours": 72, "device": null}

``store_root`` null keeps the store in memory (``NullColumnStore``);
otherwise flushes go to a ``LocalColumnStore`` there, which also pages
evicted chunks back in. ``device`` null (the default) serves on the card
and raises where there is none; ``"cpu"`` serves on the CPU. A config that
asks for a subsystem the port has not got raises ``NotImplementedError``
naming its ROADMAP item (``unported_settings``): self-telemetry, SLOs
and alerting (A6, the ``_system`` standing engine among them),
downsampling and pre-aggregation (A7), the cluster and gRPC (A9). The
index settings pass through to every shard's ``StoreConfig``:
``index_backend`` ("python", "native" or "set") and
``index_device_postings`` with its ``index_device_min_hits`` and
``index_device_max_bytes``, the tier staging on the server's device. The JAX
defaults that turn such subsystems on by themselves are off in the port
(``config.PORT_OFF``).

The query plane works as in the JAX server: ``query.parallelism`` and
``max_queued`` size the shared query pool (0: queries run on the HTTP
threads); ``batch_window_ms`` (with ``batch_max``, ``batch_window_cap_ms``
and ``batch_load_ref_cost_s``) turns on cross-query batching of fused
launches; ``tenant_quotas`` and ``admission_max_queued`` turn on admission
control, priced by the cost model (``costmodel``). A shed answers 429 with
``Retry-After``; ``/debug/scheduler`` shows the batcher and admission.

``standing.enabled`` builds a ``StandingEngine`` on the server's engine
(promotion from the scheduler's recurrence ring, delta refreshes woken
by appends, SSE push and recording rules over ``/api/v1/standing/*`` and
``/api/v1/rules/record``); ``query.prewarm.enabled`` runs the scheduler's
``prewarm_tick`` every ``interval_s``. Both are off by default in the port
(``config.PORT_OFF``); either builds the dispatch scheduler even with
batching off (window 0), for its ring. With pre-warm on, fused plans stage
the aligned range (``PlannerParams.align_staging``), so a pre-warmed
superblock is the one the next poll in its alignment bucket finds.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from .api.http import serve_background
from .coordinator.planner import PlannerParams, QueryEngine, resolve_device
from .core.schemas import Dataset
from .memstore.memstore import TimeSeriesMemStore
from .memstore.shard import StoreConfig
from .store.columnstore import LocalColumnStore, NullColumnStore
from .store.flush import FlushCoordinator, recover_shard

log = logging.getLogger("filodb_tpu_torch.server")


def unported_settings(cfg: dict) -> list[str]:
    """The settings of ``cfg`` that ask for a subsystem the port has not
    got, each with its ROADMAP item."""
    dist = cfg.get("distributed") or {}
    checks = [
        ((cfg.get("telemetry") or {}).get("self_scrape_interval_s"),
         "telemetry.self_scrape_interval_s: self-telemetry and the _system standing engine "
         "(ROADMAP A6)"),
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


# glibc's mallopt parameters (malloc.h)
_M_TRIM_THRESHOLD, _M_TOP_PAD, _M_MMAP_THRESHOLD = -1, -2, -3


def tune_heap() -> bool:
    """Keep glibc from trimming a thread's heap back to the system at every
    large free. A request handler thread that pages chunks in or stages a
    selection allocates and frees hundreds of thousands of small arrays;
    with the default threshold its arena shrinks and regrows around them,
    page faults each time (phase 17 of ``chip_smoke.py`` staged at a third
    of the speed after a page-in). Setting a threshold freezes glibc's
    dynamic mmap threshold at 128 KiB, which would map and fault every
    larger array afresh, so it is set where the dynamic one ends, 32 MiB.
    Returns False where the C library has no ``mallopt``."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    return bool(mallopt(_M_TRIM_THRESHOLD, 1 << 30) and mallopt(_M_TOP_PAD, 64 << 20)
                and mallopt(_M_MMAP_THRESHOLD, 32 << 20))


class FiloServer:
    """``start`` recovers the shards from the column store, serves the HTTP
    API on a thread and runs the maintenance loop; ``stop`` ends both."""

    def __init__(self, config: dict | None = None, device=None):
        from .config import DEFAULTS, load_config

        cfg = load_config(overrides=config or {})
        missing = unported_settings(cfg)
        if missing:
            raise NotImplementedError("not ported to filodb_tpu_torch yet: "
                                      + "; ".join(missing))
        self.config = cfg
        self.device = resolve_device(device if device is not None else cfg.get("device"))
        tune_heap()
        self.dataset = cfg["dataset"]
        self.n_shards = int(cfg["shards"])
        self.spread = int(cfg["spread"])
        self.http_port = int(cfg["http_port"])
        self.flush_interval_s = float(cfg["flush_interval_s"])
        self.maintenance_interval_s = min(self.flush_interval_s, 60.0)
        self.store_config = StoreConfig(
            max_chunk_size=int(cfg["max_chunk_size"]),
            retention_ms=int(float(cfg["retention_hours"]) * 3_600_000),
            groups_per_shard=int(cfg["groups_per_shard"]),
            max_partitions=int(cfg["max_partitions_per_shard"]),
            index_backend=cfg["index_backend"],
            index_device_postings=bool(cfg["index_device_postings"]),
            index_device_min_hits=int(cfg["index_device_min_hits"]),
            index_device_max_bytes=int(cfg["index_device_max_bytes"]),
            index_device=str(self.device),
        )
        self.memstore = TimeSeriesMemStore(self.store_config)
        self.memstore.setup(Dataset(self.dataset), range(self.n_shards),
                            total_shards=self.n_shards)
        for q in cfg.get("quotas") or []:
            for sh in self.memstore.shards(self.dataset):
                sh.cardinality.set_quota(tuple(q["prefix"]), int(q["quota"]))
        root = cfg.get("store_root")
        self.column_store = LocalColumnStore(root) if root else NullColumnStore()
        if root:
            for sh in self.memstore.shards(self.dataset):
                sh.odp_store = self.column_store
        self.flusher = FlushCoordinator(self.memstore, self.column_store)
        q = cfg["query"]
        slow = q.get("slow_query_threshold_s")
        from .metrics import SLOW_QUERY_LOG

        SLOW_QUERY_LOG.configure(int(q.get("slow_query_log_max", 64) or 64))
        self.standing_config = {**DEFAULTS["standing"], **(cfg.get("standing") or {})}
        self.prewarm_config = {**DEFAULTS["query"]["prewarm"], **(q.get("prewarm") or {})}
        self._setup_scheduling(q)
        self.engine = QueryEngine(
            self.memstore, self.dataset,
            PlannerParams(
                spread=self.spread, lookback_ms=int(q["lookback_ms"]),
                max_series=int(q["max_series"]), deadline_s=float(q["timeout_s"]),
                num_shards=self.n_shards, fused_aggregate=bool(q.get("fused_aggregate", True)),
                allow_partial_results=bool(q.get("allow_partial_results", False)),
                slow_query_threshold_s=float(slow) if slow is not None else None,
                scheduler=self.scheduler, batch_window_ms=self.batch_window_ms,
                batch_max=int(q.get("batch_max", 32) or 32), admission=self.admission,
                align_staging=bool(self.prewarm_config.get("enabled")),
            ),
            device=self.device,
            # standing promotion and pre-warm read the dispatch scheduler's
            # recurrence ring, so either needs it even with batching off
            dispatch_settings=self._dispatch_settings if (
                self.batch_window_ms > 0 or self.standing_config.get("enabled")
                or self.prewarm_config.get("enabled")) else None,
        )
        self.dispatch_scheduler = self.engine.planner.params.dispatch_scheduler
        # the standing-query engine: bound to the serving engine, over the
        # server's dataset
        self.standing = None
        if self.standing_config.get("enabled"):
            from .standing import StandingEngine

            self.standing = StandingEngine(self.engine, self.standing_config)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._http = None

    def _setup_scheduling(self, q: dict) -> None:
        """The query pool, the cost model's settings, the dispatch
        scheduler's settings and admission, from the ``query`` config (the
        JAX server's)."""
        from .coordinator.scheduler import QueryScheduler
        from .config import DEFAULTS
        from .query.costmodel import COST_MODEL
        from .query.scheduler import AdmissionController

        self.scheduler = None
        if int(q.get("parallelism", 0) or 0) > 0:
            self.scheduler = QueryScheduler(parallelism=int(q["parallelism"]),
                                            max_queued=int(q.get("max_queued", 64)))
        cm = {**DEFAULTS["query"]["costmodel"], **(q.get("costmodel") or {})}
        COST_MODEL.configure(prior_cost_s=float(cm["prior_cost_s"]), alpha=float(cm["alpha"]),
                             cold_multiplier=float(cm["cold_multiplier"]))
        prior_cost_s = float(cm["prior_cost_s"])
        self.batch_window_ms = float(q.get("batch_window_ms", 0) or 0)
        # the dispatch scheduler's settings; the engine builds it
        self._dispatch_settings = dict(
            key_ring_max=int(self.standing_config.get("key_ring_max", 512) or 512),
            window_cap_ms=float(q.get("batch_window_cap_ms", 0) or 0),
            load_ref_cost_s=float(q.get("batch_load_ref_cost_s", 0.25) or 0.25),
            prior_cost_s=prior_cost_s,
            prewarm_min_count=int(self.prewarm_config.get("min_count", 3) or 3))
        self.admission = None
        quotas = q.get("tenant_quotas") or {}
        max_queued = int(q.get("admission_max_queued", 0) or 0)
        if quotas or max_queued:
            self.admission = AdmissionController(quotas, max_queued=max_queued,
                                                 prior_cost_s=prior_cost_s)

    def recover(self) -> dict[int, int]:
        """Rebuild the shards from the column store; returns each shard's
        offset to replay its ingestion stream from (-1: none)."""
        offsets = {s: recover_shard(self.memstore, self.column_store, self.dataset, s)
                   for s in self.memstore.shard_nums(self.dataset)}
        log.info("recovered %d shards: %s", len(offsets), offsets)
        return offsets

    def start(self, port: int | None = None) -> int:
        """Recover, serve the HTTP API (``port`` 0: any free port) and start
        the maintenance loop; returns the port."""
        self.recover()
        self._http, actual = serve_background(
            self.engine, host=self.config.get("http_host") or "127.0.0.1",
            port=self.http_port if port is None else port,
            auth_token=self.config.get("http_auth_token"),
            result_plane=self.config.get("result_plane"), flush_hook=self.flush_now,
            standing=self.standing)
        if self.standing is not None:
            self.standing.start()
        t = threading.Thread(target=self._maintenance_loop, daemon=True,
                             name="filodb-maintenance")
        t.start()
        self._threads.append(t)
        if (self.dispatch_scheduler is not None and self.prewarm_config.get("enabled")
                and int(self.prewarm_config.get("per_tick", 2) or 0) > 0):
            tp = threading.Thread(target=self._prewarm_loop, daemon=True, name="filodb-prewarm")
            tp.start()
            self._threads.append(tp)
        log.info("filodb_tpu_torch serving on :%d (%d shards, %s)", actual, self.n_shards,
                 self.device)
        return actual

    def stop(self) -> None:
        self._stop.set()
        if self.standing is not None:
            self.standing.stop()
        if self.scheduler is not None:
            self.scheduler.shutdown()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _prewarm_loop(self) -> None:
        """Every ``query.prewarm.interval_s``: one pre-warm pass
        (``DispatchScheduler.prewarm_tick``) off the serving path."""
        interval = float(self.prewarm_config.get("interval_s", 5.0) or 5.0)
        limit = int(self.prewarm_config.get("per_tick", 2) or 2)
        while not self._stop.wait(interval):
            try:
                self.dispatch_scheduler.prewarm_tick(limit=limit)
            except Exception:  # noqa: BLE001 -- the loop must outlive a bad tick
                log.exception("prewarm tick failed")

    def _maintenance_loop(self) -> None:
        """Every interval: flush once ``flush_interval_s`` has passed, evict
        by retention and headroom (reference flush timer + evictForHeadroom),
        and refresh the device ledger's gauges so ``filodb_device_bytes``
        stays current between scrapes."""
        from .ledger import LEDGER

        last_flush = time.time()
        while not self._stop.wait(self.maintenance_interval_s):
            now = time.time()
            if now - last_flush >= self.flush_interval_s:
                try:
                    self.flush_now()
                except Exception:  # noqa: BLE001 -- the loop must outlive a bad tick
                    log.exception("flush failed")
                last_flush = now
            for sh in self.memstore.shards(self.dataset):
                sh.evict_for_retention()
                sh.evict_for_headroom()
            try:
                LEDGER.publish()
            except Exception:  # noqa: BLE001
                log.exception("ledger refresh failed")

    def flush_now(self):
        """Flush every shard of the dataset (the ``/admin/flush`` route);
        returns the ``FlushResult`` totals."""
        return self.flusher.flush_all(self.dataset)


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
