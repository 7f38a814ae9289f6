"""CLI of the port (counterpart of ``filodb_tpu/cli.py``; reference L7
cli/CliMain.scala): PromQL queries against a running server, label and
series tools, CSV import, and the port's own server.

Usage:
  python -m filodb_tpu_torch.cli serve [--config cfg.json] [--port 9090] [--device cpu]
  python -m filodb_tpu_torch.cli query        --host URL "sum(rate(m[5m]))" --time T
  python -m filodb_tpu_torch.cli query-range  --host URL "m" --start A --end B --step S
  python -m filodb_tpu_torch.cli labels       --host URL
  python -m filodb_tpu_torch.cli label-values --host URL instance
  python -m filodb_tpu_torch.cli series       --host URL 'm{job="x"}'
  python -m filodb_tpu_torch.cli ingest-csv   --host URL data.csv   (metric,tags,ts_ms,value)
  python -m filodb_tpu_torch.cli partkey      'm{job="x"}'          (debug: hash/shard)

``serve`` takes the card unless ``--device cpu`` is given. The store tools
of the JAX CLI (``downsample-batch``, ``churn-find``, ``cardbust``,
``copy-store``) work on a persisted store, which the port has not got:
they raise, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request


def _get(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _print(obj):
    json.dump(obj, sys.stdout, indent=2)
    print()


def cmd_query(args):
    q = urllib.parse.quote(args.query)
    t = f"&time={args.time}" if args.time else ""
    _print(_get(f"{args.host}/api/v1/query?query={q}{t}"))


def cmd_query_range(args):
    q = urllib.parse.quote(args.query)
    _print(_get(
        f"{args.host}/api/v1/query_range?query={q}&start={args.start}&end={args.end}&step={args.step}"
    ))


def cmd_labels(args):
    _print(_get(f"{args.host}/api/v1/labels"))


def cmd_label_values(args):
    _print(_get(f"{args.host}/api/v1/label/{args.label}/values"))


def cmd_series(args):
    m = urllib.parse.quote(args.match)
    _print(_get(f"{args.host}/api/v1/series?match[]={m}"))


def cmd_ingest_csv(args):
    import csv

    lines = []
    with open(args.file) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            metric, tagstr, ts_ms, value = row
            tags = {"__name__": metric}
            if tagstr:
                for kv in tagstr.split(";"):
                    k, _, v = kv.partition("=")
                    tags[k] = v
            lines.append(json.dumps({"tags": tags, "ts_ms": int(ts_ms), "value": float(value)}))
    req = urllib.request.Request(
        f"{args.host}/ingest", data="\n".join(lines).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        _print(json.loads(r.read()))


def cmd_partkey(args):
    """Debug: show canonical partkey, hashes, shard routing (reference
    CliMain promFilterToPartKeyBR:222 / partKeyBrAsString debug tools)."""
    from .core import schemas as S
    from .query.promql import Parser

    sel = Parser(args.selector).selector()
    tags = {f.column: f.value for f in sel.matchers}
    if sel.metric:
        tags[S.METRIC_TAG] = sel.metric
    _print(
        {
            "tags": tags,
            "partkey": S.canonical_partkey(tags).decode(errors="replace"),
            "partkey_hash": f"{S.partkey_hash(tags):016x}",
            "shardkey_hash": f"{S.shardkey_hash(tags):016x}",
            "shard": {
                f"spread={sp},shards={n}": S.shard_for(tags, sp, n)
                for sp, n in ((1, 8), (3, 32), (5, 128))
            },
        }
    )


def _unported(item: str):
    def cmd(args):
        raise NotImplementedError(
            f"{args.cmd} works on a persisted store, which filodb_tpu_torch has not got "
            f"yet (ROADMAP {item})")

    return cmd


def cmd_serve(args):
    from .server import main as server_main

    argv = []
    if args.config:
        argv += ["--config", args.config]
    if args.port:
        argv += ["--port", str(args.port)]
    if args.device:
        argv += ["--device", args.device]
    server_main(argv)


def main(argv=None):
    p = argparse.ArgumentParser("filodb-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def host_arg(sp):
        sp.add_argument("--host", default="http://127.0.0.1:9090")

    sp = sub.add_parser("serve")
    sp.add_argument("--config")
    sp.add_argument("--port", type=int)
    sp.add_argument("--device", default=None, help="cpu to serve on the CPU (default: the card)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("query")
    host_arg(sp)
    sp.add_argument("query")
    sp.add_argument("--time", default=None)
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("query-range")
    host_arg(sp)
    sp.add_argument("query")
    sp.add_argument("--start", required=True)
    sp.add_argument("--end", required=True)
    sp.add_argument("--step", default="15")
    sp.set_defaults(fn=cmd_query_range)

    sp = sub.add_parser("labels")
    host_arg(sp)
    sp.set_defaults(fn=cmd_labels)

    sp = sub.add_parser("label-values")
    host_arg(sp)
    sp.add_argument("label")
    sp.set_defaults(fn=cmd_label_values)

    sp = sub.add_parser("series")
    host_arg(sp)
    sp.add_argument("match")
    sp.set_defaults(fn=cmd_series)

    sp = sub.add_parser("ingest-csv")
    host_arg(sp)
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_ingest_csv)

    sp = sub.add_parser("partkey")
    sp.add_argument("selector")
    sp.set_defaults(fn=cmd_partkey)

    # the JAX CLI's store tools, with their arguments: they raise
    sp = sub.add_parser("downsample-batch")
    sp.add_argument("--store", required=True)
    sp.add_argument("--dataset", default="prometheus")
    sp.add_argument("--periods", default="5,60", help="minutes, comma-separated")
    sp.add_argument("--processes", type=int, default=0,
                    help="process-pool workers for the scan+reduce phase "
                         "(one task per shard; the Spark-executor analog)")
    sp.add_argument("--distributed", action="store_true",
                    help="run as ONE worker of a multi-process job: claim "
                         "shards via the store root, commit atomically, "
                         "break stale claims (reference DownsamplerMain "
                         "over executors; rerun to resume after crashes)")
    sp.add_argument("--worker-id", default="")
    sp.add_argument("--job-label", default="default")
    sp.add_argument("--stale-s", type=float, default=30.0)
    sp.set_defaults(fn=_unported("A7"))

    sp = sub.add_parser("churn-find")
    sp.add_argument("--store", required=True)
    sp.add_argument("--dataset", default="prometheus")
    sp.add_argument("--active-hours", type=float, default=2.0,
                    help="liveness window: series ended within this many "
                         "hours count as active")
    sp.add_argument("--min-total", type=int, default=100)
    sp.add_argument("--min-ratio", type=float, default=2.0)
    sp.set_defaults(fn=_unported("A7"))

    sp = sub.add_parser("cardbust")
    sp.add_argument("--store", required=True)
    sp.add_argument("--dataset", default="prometheus")
    sp.add_argument("selector")
    sp.set_defaults(fn=_unported("A4"))

    sp = sub.add_parser("copy-store")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)
    sp.add_argument("--dataset", default="prometheus")
    sp.set_defaults(fn=_unported("A4"))

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
