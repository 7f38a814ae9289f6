#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone, at a chosen series count, on one
NVIDIA card: the persistence path (flush, restart and recovery, on-demand
paging, retention) through the port's server, after building phase 5's
store at the same size for the answers it is held to.

    python3 persist_check.py [--series N] [--seed S] [--page-in]

``--page-in`` then times the page-in alone, outside any query: a store of
N series flushed to a column store, every shard evicted (tier 2) and paged
back in, twice, with the seconds spent reading and decoding the frames.
Exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time


def page_in_split(n_series: int, seed: int) -> list[dict]:
    """The page-in of every chunk of an ``n_series`` store, twice, split into
    the frames' reading, their decoding and the rest."""
    import chip_smoke as C
    from filodb_tpu_torch.core import encodings as E
    from filodb_tpu_torch.core.schemas import Dataset
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig
    from filodb_tpu_torch.store import columnstore as CS
    from filodb_tpu_torch.store.flush import FlushCoordinator

    ms = TimeSeriesMemStore(StoreConfig())
    ms.setup(Dataset("prometheus"), range(C.N_SHARDS))
    C.build_memstore(n_series, C.N_SAMPLES, seed, "regular", ms=ms)
    root = tempfile.mkdtemp(prefix="filodb-store-")
    spent = {"read": 0.0, "decode": 0.0}
    read, decode = CS.LocalColumnStore.read_chunks_selective, E.decode_many

    def timed_read(self, *a, **k):
        t0 = time.perf_counter()
        frames = list(read(self, *a, **k))
        spent["read"] += time.perf_counter() - t0
        return iter(frames)

    def timed_decode(*a, **k):
        t0 = time.perf_counter()
        out = decode(*a, **k)
        spent["decode"] += time.perf_counter() - t0
        return out

    runs = []
    try:
        store = CS.LocalColumnStore(root)
        t0 = time.perf_counter()
        FlushCoordinator(ms, store).flush_all("prometheus")
        flush_s = time.perf_counter() - t0
        CS.LocalColumnStore.read_chunks_selective, E.decode_many = timed_read, timed_decode
        for _ in range(2):
            for sh in ms.shards("prometheus"):
                sh.odp_store = store
                sh.evict_for_headroom(target_bytes=0)
            spent.update(read=0.0, decode=0.0)
            t0 = time.perf_counter()
            frames = sum(sh.odp_page_in(list(sh.partitions), 0, 2**62)
                         for sh in ms.shards("prometheus"))
            total = time.perf_counter() - t0
            runs.append({"frames": frames, "page_in_s": total, "read_s": spent["read"],
                         "decode_s": spent["decode"], "us_a_frame": total / frames * 1e6,
                         "flush_s": flush_s})
            print(f"page-in of {frames} frames: {total:.2f} s ({total / frames * 1e6:.1f} us a "
                  f"frame; reading {spent['read']:.2f} s, decoding {spent['decode']:.2f} s); "
                  f"the flush before {flush_s:.2f} s", flush=True)
    finally:
        CS.LocalColumnStore.read_chunks_selective, E.decode_many = read, decode
        shutil.rmtree(root, ignore_errors=True)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-in", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("persist_check: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from filodb_tpu_torch.coordinator.planner import QueryEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    C.N_SERIES = C.PERSIST_SERIES = args.series
    card = C.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    engine = QueryEngine(C.build_memstore(args.series, C.N_SAMPLES, args.seed, "regular"),
                         "prometheus")
    want = {q: C.engine_rows(engine.query_range(q, C.START_S, C.END_S, C.STEP_S))
            for q in C.QUERIES}
    print(f"phase 5's store and answers at {args.series} series: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"phase17": C.phase_persistence(args.seed, torch.device("cuda"), card, want)}
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.page_in:
        gc.collect()
        out["page_in"] = page_in_split(args.series, args.seed)
    print(json.dumps(out))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
