"""Server configuration of the port (counterpart of ``filodb_tpu/config.py``;
reference filodb-defaults.conf): a documented JSON-shaped dict of defaults
merged with a user config file and overrides.

The keys and their defaults are the JAX package's, with these differences:

- ``device``: where the server's queries run: ``None`` for the card (the
  default; with no card the server raises), or ``"cpu"``.
- Subsystems the JAX package turns on by itself and the port has not got
  yet are off here (``PORT_OFF``, shown at ``/api/v1/status/flags``): the
  query scheduler pool, executable pre-warm, standing queries, the rollup
  tier and its chooser, and the TPU watch log; the result plane's peer
  exchange is JSON (the port serves no Arrow frames).
- ``compile_cache_dir`` is gone: the port's kernels build with nvcc into
  the package's build directory (``ops/cuda_build.py``).

A config that turns one of the missing subsystems on makes ``FiloServer``
raise ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import json

DEFAULTS: dict = {
    # dataset / sharding (reference filodb.dataset-configs + spread-default)
    "dataset": "prometheus",
    "shards": 8,
    "spread": 3,
    # memstore (reference filodb.memstore block)
    "max_chunk_size": 400,
    "retention_hours": 72,
    "groups_per_shard": 16,
    "max_partitions_per_shard": 1_000_000,
    # "python" = vectorized posting-bitmap index (default), "native" = C++
    # posting lists, "set" = the retained set-arithmetic oracle
    "index_backend": "python",
    # opt-in HBM tier for hot posting bitmaps (doc/perf.md "Vectorized
    # part-key index": all-equality selectors over staged bitmaps resolve
    # as one tiny jit intersection; ledger kind index_postings)
    "index_device_postings": False,
    "index_device_min_hits": 16,
    "index_device_max_bytes": 64 << 20,
    # flush / persistence
    "flush_interval_s": 3600,
    "store_root": None,  # None = memory-only (NullColumnStore)
    # where queries run: None = the card (raises without one), or "cpu"
    "device": None,
    # query limits (reference filodb.query circuit breaker / limits)
    "query": {
        "max_series": 1_000_000,
        "max_samples": 500_000_000,
        "lookback_ms": 300_000,
        "timeout_s": 60,
        # bounded shared scheduler (reference query-sched parallelism):
        # 0 = run queries inline on the API edge threads (tests/embedding)
        "parallelism": 8,
        "max_queued": 64,
        # single-dispatch cross-shard aggregates (doc/perf.md): plan
        # sum|avg|min|max|count over range functions as ONE fused kernel
        # dispatch over a device-resident superblock when all shards are
        # local. false forces the reference scatter/partial-merge tree.
        "fused_aggregate": True,
        # fault tolerance (query/faults.py): default partial-results stance
        # (per-request allow_partial_results overrides), remote-child retry
        # budget, and per-endpoint circuit-breaker thresholds
        "allow_partial_results": False,
        "retry": {
            "max_attempts": 3,
            "base_backoff_s": 0.1,
            "max_backoff_s": 2.0,
        },
        "breaker": {
            "window": 16,
            "failure_rate": 0.5,
            "min_calls": 4,
            "cooldown_s": 15.0,
        },
        # observability (metrics.py): queries slower than the threshold
        # record PromQL + rendered trace tree in the slow-query log
        # (/debug/slow_queries, counted as filodb_slow_queries_total).
        # null disables; log size is a ring buffer.
        "slow_query_threshold_s": 10.0,
        "slow_query_log_max": 64,
        # query observatory (obs/querylog.py, doc/observability.md "Query
        # observatory"): every executed query leaves one exemplar-level
        # cost record (phases, path, stats) in a bounded ring served at
        # /debug/querylog and /api/v1/query_profile?id=. This sizes the
        # ring; capture itself is always on (host-side metadata only).
        "querylog_max": 512,
        # cross-query micro-batching (query/scheduler.py): concurrent
        # fused queries sharing a hot superblock + grid/epilogue signature
        # collect for this window and launch as ONE batched kernel (vmap
        # over per-query window/offset/q/group-by). 0 disables. Every
        # fused query pays up to the window in added latency, so this is
        # the high-QPS-serving knob: enable (1-5 ms) when concurrent
        # dashboard fan-out dominates, keep 0 for latency-critical
        # single-user setups. batch_max closes a group early.
        "batch_window_ms": 0.0,
        "batch_max": 32,
        # adaptive batch window (query/scheduler.py, doc/perf.md
        # "Cost-model scheduling"): with a cap > batch_window_ms the
        # effective window scales with predicted queued device-seconds —
        # it collapses toward ZERO when the node idles (no batching tax)
        # and widens toward the cap as predicted load approaches
        # batch_load_ref_cost_s (decayed accumulator of admitted
        # predicted costs). 0 keeps the window fixed at batch_window_ms.
        "batch_window_cap_ms": 0.0,
        "batch_load_ref_cost_s": 0.25,
        # executable pre-warm (doc/perf.md): a background tick scans the
        # scheduler's recurrence ring for keys seen >= prewarm_min_count
        # times (any recurrence during a recompile storm) and trace+
        # compiles their programs off the serving path, so the first real
        # poll of a soon-hot dashboard pays zero compiles. 0 disables the
        # tick; interval_s paces it.
        "prewarm": {
            "enabled": True,
            "min_count": 3,
            "interval_s": 5.0,
            "per_tick": 2,
        },
        # work cost model (query/costmodel.py): predicted device-seconds
        # per query from the normalized-promql fingerprint joined to the
        # kernel registry's warm dispatch stats. prior_cost_s doubles as
        # the legacy query-count -> device-second quota conversion rate;
        # alpha is the online EWMA step; cold fingerprints price at
        # family-mean * cold_multiplier (the compile they may trigger).
        "costmodel": {
            "prior_cost_s": 0.05,
            "alpha": 0.3,
            "cold_multiplier": 2.0,
        },
        # per-tenant admission control (doc/operations.md): maps "ws/ns"
        # (or "*" = default for every tenant, including "unknown") to
        # {"rate_device_s": device-seconds/s, "burst_device_s": bucket,
        # "max_concurrent": n}. Buckets refill in predicted DEVICE-SECONDS
        # (the cost model prices each query), so an expensive query drains
        # proportionally more than a cheap one. Legacy {"rate": queries/s,
        # "burst": n} configs convert via costmodel.prior_cost_s. Over-
        # quota queries shed with HTTP 429 + Retry-After derived from the
        # bucket's actual predicted drain time (gRPC: typed in-band error
        # + retry-after metadata). Empty = no tenant quotas.
        "tenant_quotas": {},
        # global bound on admitted-and-unfinished queries (0 = unbounded);
        # past it every tenant sheds with 429 until in-flight drains
        "admission_max_queued": 0,
    },
    # API
    "http_port": 9090,
    # gRPC RemoteExec service (api/grpc_exec.py; reference PromQLGrpcServer +
    # query_service.proto RemoteExec). null = disabled; 0 = ephemeral port.
    # Peers declared as "grpc://host:port" in distributed.peers use it for
    # binary plan-level scatter instead of PromQL-over-HTTP. grpc_host
    # defaults loopback-only; multi-host deployments set "0.0.0.0" AND an
    # http_auth_token (the service executes arbitrary queries).
    "grpc_port": None,
    "grpc_host": "127.0.0.1",
    # optional bearer token protecting /api/* (remote execs send it via
    # FILODB_REMOTE_TOKEN); null = open
    "http_auth_token": None,
    # multi-host deployment: each process owns a shard slice and scatters
    # queries to its peers over HTTP. "coordinator" joins the JAX
    # distributed runtime for cross-host meshes (null = skip); env
    # FILODB_COORDINATOR/FILODB_NUM_PROCESSES/FILODB_PROCESS_ID override.
    # "peers": base URLs of the OTHER processes; "owned_shards": explicit
    # shard list for this process (default: ordinal slice of "shards").
    # "seeds": bootstrap URLs polled for /__members at startup (the
    # akka-bootstrapper whitelist analog); discovered members become query
    # peers dynamically and a refresh loop ages dead ones out.
    # "advertise_url": this node's URL as peers should reach it (required
    # with seeds unless the default http://127.0.0.1:<port> is reachable).
    "distributed": {
        "coordinator": None, "num_processes": None, "process_id": None,
        "peers": [], "owned_shards": None,
        "seeds": [], "advertise_url": None, "refresh_interval_s": 30,
    },
    # standing-query engine (filodb_tpu/standing/, doc/operations.md
    # "Standing queries & recording rules"): hot recurring live-edge
    # queries promote into registered standing queries whose [G, J]
    # partials are DELTA-maintained on ingest append and served by push
    # (SSE fan-out) — plus the recording-rules API. Promotion needs
    # promote_min_count recurrences inside promote_window_s from a query
    # whose grid end trails wall clock by at most promote_live_lag_ms;
    # auto-promoted queries demote after demote_idle_s of no recurrence
    # and no subscribers (hysteresis). max_subscribers bounds SSE fan-out
    # per standing query; key_ring_max bounds the scheduler's retained
    # per-key recurrence ring; align_ms quantizes staging ranges so every
    # refresh rides ONE extendable superblock cache entry.
    # "serve_range": ordinary /api/v1/query_range requests that match a
    # registered standing query's promql+step serve straight from its
    # retained [G, J] partials (querylog path standing:serve) instead of
    # re-executing.
    "standing": {
        "enabled": True,
        "serve_range": True,
        "promote_min_count": 8,
        "promote_window_s": 120.0,
        "promote_live_lag_ms": 120_000,
        "demote_idle_s": 600.0,
        "demote_retry_s": 3600.0,
        "max_standing": 64,
        "max_subscribers": 64,
        "refresh_debounce_ms": 250,
        "key_ring_max": 512,
        "default_span_ms": 1_800_000,
        "align_ms": 300_000,
        "tick_s": 0.5,
    },
    # result plane (doc/perf.md "Result plane"): how query results leave
    # the node. stream_min_samples: above this, query_range bodies stream
    # chunked with D2H/encode overlap; stream_block_rows: series rows per
    # device->host block on that path (0 pulls whole grids upfront);
    # peer_exchange: "arrow" serves/requests columnar Arrow IPC frames on
    # node-to-node hops (JSON renders exactly once, at the user edge),
    # "json" forces decimal JSON on every hop (debug / rolling downgrade).
    "result_plane": {
        "stream_min_samples": 200_000,
        "stream_block_rows": 512,
        "peer_exchange": "arrow",
    },
    # kernel & compile observatory (obs/kernels.py, doc/observability.md
    # "Kernel & compile observatory"): every jitted kernel dispatch is
    # accounted per executable (compiles, dispatches, device p50/p99,
    # compile-cache provenance) at /debug/kernels — capture is always on,
    # these knobs size the table and the recompile-storm detector. A family
    # compiling more than storm_threshold times inside storm_window_s
    # counts filodb_xla_recompile_storms_total and annotates the unstable
    # key dimension. device_timing adds a block_until_ready around each
    # warm dispatch for exact device cost (bench/attest runs turn it on;
    # serving keeps it off — the sync serializes the dispatch pipeline).
    "kernel_obs": {
        "max_executables": 1024,
        "storm_threshold": 5,
        "storm_window_s": 60.0,
        "device_timing": False,
    },
    # downsampling (reference downsample resolutions)
    "downsample": {"enabled": False, "periods_m": [5, 60]},
    # sketch rollup tier (downsample/rollup.py + downsample/chooser.py,
    # doc/perf.md "Sketch rollup tier"): per-period mergeable summary
    # blocks (log-linear sketch + min/max/sum/count moments) maintained
    # over the ingest path; the planner substitutes them for long-range
    # window queries whose step/window the resolution divides, so a
    # 30-day quantile reads O(periods) instead of O(raw samples). The
    # chooser trains the rollup set on the querylog: a fingerprint
    # recurring >= min_count times with span >= min_span_ms earns a
    # rollup at the coarsest ladder resolution serving its shape;
    # chooser-owned entries idle > idle_s retire. grace_ms holds back
    # the fold watermark so the live edge stays raw-served.
    "rollup": {
        "enabled": True,
        "grace_ms": 120_000,
        "max_entries": 64,
        "tick_s": 5.0,
        "chooser": {
            "enabled": True,
            "resolutions_ms": [300_000, 3_600_000],
            "min_count": 3,
            "min_span_ms": 86_400_000,
            "idle_s": 3600.0,
            "interval_s": 30.0,
        },
    },
    # cardinality quotas: list of {"prefix": ["ws","ns"], "quota": N}
    "quotas": [],
    # streaming preagg rules: [{"metric_regex", "include_tags"|"exclude_tags"}]
    "preagg_rules": [],
    # profiler (reference filodb.profiler)
    "profiler": {"enabled": False, "interval_ms": 10},
    # self-telemetry (telemetry.py): when self_scrape_interval_s is set the
    # server samples its own /metrics registry every interval and ingests
    # the samples as real time series into the "_system" dataset, queryable
    # through the standard query API via ?dataset=_system (so dashboards
    # over the server's own kernel/cache/tenant metrics run through the
    # fused query path). null disables. tpu_watch_log: path of the
    # tools/tpu_watch.py log to surface as filodb_tpu_* gauges ("auto" =
    # <repo>/TPU_WATCH_LOG.txt when present; null disables).
    "telemetry": {
        "self_scrape_interval_s": None,
        "self_scrape_spread": 1,
        "tpu_watch_log": "auto",
    },
    # SLO burn-rate recording rules over the query observatory (obs/slo.py,
    # doc/observability.md "SLO burn-rate rules"): a second standing-query
    # maintainer bound to the _system engine evaluates default availability
    # (non-5xx share of non-shed responses vs the error budget) and latency
    # (p99 vs objective) burn rates and writes them back into _system as
    # real series. enabled null = auto: on exactly when the _system
    # pipeline runs (telemetry.self_scrape_interval_s set) and the
    # standing engine is enabled. latency_objectives_s maps "ws/ns" (or
    # "*" = global) to a p99 objective in seconds.
    "slo": {
        "enabled": None,
        "availability_objective": 0.999,
        "latency_objectives_s": {"*": 2.0},
        "windows": ["5m", "1h"],
        "interval_s": 15.0,
    },
    # alerting plane (obs/alerting.py + obs/notify.py, doc/observability.md
    # "Alerting plane"): Prometheus-compatible alerting rule groups loaded
    # from rule_files (globs) and POST /api/v1/rules/alert, evaluated on
    # the _system standing engine (each rule's expr is a standing query;
    # the newest closed step feeds the inactive→pending→firing state
    # machine), with state written back as ALERTS / ALERTS_FOR_STATE
    # series (restart-safe via rehydrate_lookback_ms) and firing alerts
    # fanned out to Alertmanager-v2 webhook receivers
    # ([{name, url, group_by, group_wait, group_interval, repeat_interval,
    # send_resolved}]). enabled null = auto: on exactly when the _system
    # standing engine runs.
    "alerting": {
        "enabled": None,
        "rule_files": [],
        "default_interval_s": 15.0,
        "rehydrate_lookback_ms": 3_600_000,
        "notify_tick_s": 1.0,
        "notify_deadline_s": 10.0,
        "receivers": [],
    },
}


# (path, the port's value, why): JAX defaults that switch on a subsystem the
# port has not got; the port's DEFAULTS hold them off
PORT_OFF = (
    (("query", "parallelism"), 0, "query scheduler pool (ROADMAP A5)"),
    (("query", "prewarm", "enabled"), False, "executable pre-warm (ROADMAP A5)"),
    (("standing", "enabled"), False, "standing queries (ROADMAP A5)"),
    (("rollup", "enabled"), False, "sketch rollup tier (ROADMAP A7)"),
    (("rollup", "chooser", "enabled"), False, "rollup chooser (ROADMAP A7)"),
    (("result_plane", "peer_exchange"), "json", "Arrow peer frames (need pyarrow)"),
    (("telemetry", "tpu_watch_log"), None, "TPU watch log (a TPU tool)"),
)


def _set_path(cfg: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        cfg = cfg[k]
    cfg[path[-1]] = value


for _path, _value, _why in PORT_OFF:
    _set_path(DEFAULTS, _path, _value)


def load_config(path: str | None = None, overrides: dict | None = None) -> dict:
    """defaults <- file <- overrides (later wins, one level deep for dicts)."""
    cfg = json.loads(json.dumps(DEFAULTS))  # deep copy
    layers = []
    if path:
        with open(path) as f:
            layers.append(json.load(f))
    if overrides:
        layers.append(overrides)
    for layer in layers:
        for k, v in layer.items():
            if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
    return cfg
