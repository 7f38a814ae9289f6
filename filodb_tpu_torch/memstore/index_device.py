"""Opt-in device tier for hot posting bitmaps (counterpart of
``filodb_tpu/memstore/index_device.py``; ``StoreConfig.index_device_postings``).

For a large tenant, selector resolution is the same AND over the same few
posting bitmaps again and again (``_ws_``/``_ns_``/``_metric_`` equality).
The tier watches the index's observed equality traffic
(``PartKeyIndex.traffic``, fed by the lookup path) and stages the hottest
(label, value) bitmaps on its device as packed 64-bit words (int64
tensors, ``ops/postings_kernels.host_words_to_device``). An all-equality
lookup whose matchers are all staged and current resolves as one launch of
the postings-intersection kernel (``ops/postings_kernels.intersect_words``,
``csrc/postings.cu``) and one copy of its ``[W]`` words to the host; a
selector of one matcher copies its staged bitmap back with no launch.

A matcher that is not staged, or whose staged copy is stale, sends the
lookup to the host path, as in the JAX design (so do staged bitmaps of
different widths, staged before and after the id universe grew);
``stats["host_fallbacks"]``
counts those lookups, ``stats["intersections"]`` the ones the tier
resolved. A ``{k=""}`` matcher is never staged: it also matches series
missing the tag, which a posting bitmap alone does not hold.

Accounting: every staged bitmap debits the device ledger under the
``index_postings`` kind; drops and invalidations credit it back, and the
ledger's drift check recounts through ``_tier_walker``.

Consistency: a staged entry records its label's ``post_version``. Any
posting change under that label (a new series, a removal) moves the
version; the entry is then dropped at its next use and staged again by the
next ``maintain()``. A stale bitmap is never read.

The device is the one the owning shard's store runs its queries on
(``StoreConfig.index_device``): the card unless the caller asks for
``"cpu"``, where the intersection runs its plain version (the tests).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch


def _tier_walker(tier: "DevicePostingsTier") -> int:
    """The ledger drift check's ground truth: the staged bytes recounted."""
    with tier._lock:
        return sum(e.nbytes for e in tier._staged.values())


def _tier_devices(tier: "DevicePostingsTier") -> dict:
    with tier._lock:
        n = sum(e.nbytes for e in tier._staged.values())
    return {str(tier.device): n} if n else {}


class _Entry:
    __slots__ = ("dev", "nbytes", "post_version", "hits")

    def __init__(self, dev: torch.Tensor, nbytes: int, post_version: int):
        self.dev = dev
        self.nbytes = int(nbytes)
        self.post_version = post_version
        self.hits = 0


class DevicePostingsTier:
    """Hot posting bitmaps of one shard's index, staged on ``device``."""

    def __init__(self, index, device, min_hits: int = 16, max_bytes: int = 64 << 20,
                 name: str = ""):
        from ..ledger import LEDGER

        self.index = index
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the index's device tier; "
                               "pass index_device='cpu' to stage on the CPU")
        self.min_hits = int(min_hits)
        self.max_bytes = int(max_bytes)
        self._staged: dict[tuple[str, str], _Entry] = {}
        self._lock = threading.Lock()
        self.stats = {"intersections": 0, "host_fallbacks": 0, "staged": 0, "dropped": 0}
        self._maintaining = False
        # the opportunistic sweep runs at most this often: a warm lookup
        # storm must not pay the sort and probe walk (or a thread start)
        # every 256th call for nothing
        self.sweep_min_interval_s = 2.0
        self._last_sweep = 0.0
        self.ledger = LEDGER.register(self, "index_postings", _tier_walker,
                                      name=name or "index-device-tier",
                                      device_walker=_tier_devices)

    # -- staging policy ----------------------------------------------------

    def maintain(self, max_stage: int = 8) -> int:
        """Stage up to ``max_stage`` of the hottest posting bitmaps not yet
        staged or stale (traffic >= min_hits), hottest first, within the
        byte budget. Returns the entries staged. Called every 256th lookup
        (on a thread, rate-limited) and directly by tests and operators,
        never on the lookup path itself."""
        from ..ops.postings_kernels import host_words_to_device
        from . import postings as P

        idx = self.index
        staged = 0
        with idx._lock:
            hot = sorted(((hits, key) for key, hits in idx.traffic.items()
                          if hits >= self.min_hits), reverse=True)
            snapshots = []
            for _hits, (label, value) in hot:
                if len(snapshots) >= max_stage:
                    break
                with self._lock:
                    cur = self._staged.get((label, value))
                L = idx._labels.get(label)
                c = L.containers.get(value) if L is not None else None
                if c is None:
                    continue
                if cur is not None and cur.post_version == L.post_version:
                    continue  # a current copy is staged already
                view = c.view(idx._nbits)
                words = (view[1] if view[0] == "d"
                         else P.ids_to_dense(view[1], P.nwords(idx._nbits)))
                # a dense container may be narrower than the universe:
                # every staged bitmap spans all of it, so their widths match
                words = P.grow_words(words, P.nwords(idx._nbits))
                snapshots.append(((label, value), words.copy(), L.post_version))
        # the copies to the device run outside the index lock: staging never
        # stalls concurrent lookups or ingest
        for key, words, pv in snapshots:
            nbytes = words.nbytes
            with self._lock:
                held = sum(e.nbytes for e in self._staged.values())
                if held + nbytes > self.max_bytes:
                    break
            dev = host_words_to_device(words, self.device)
            with self._lock:
                # the budget again under the lock: concurrent sweeps must not
                # compound past max_bytes
                old = self._staged.get(key)
                held = (sum(e.nbytes for e in self._staged.values())
                        - (old.nbytes if old is not None else 0))
                if held + nbytes > self.max_bytes:
                    break
                if old is not None:
                    self.ledger.free(old.nbytes, reason="replace")
                self._staged[key] = _Entry(dev, nbytes, pv)
                self.ledger.alloc(nbytes)
                self.stats["staged"] += 1
            staged += 1
        return staged

    def drop(self, key: tuple[str, str], reason: str = "drop") -> None:
        with self._lock:
            e = self._staged.pop(key, None)
            if e is not None:
                self.ledger.free(e.nbytes, reason=reason)
                self.stats["dropped"] += 1

    def clear(self) -> None:
        with self._lock:
            if self._staged:
                self.ledger.free(sum(e.nbytes for e in self._staged.values()),
                                 reason="invalidate", count=len(self._staged))
            self._staged.clear()

    # -- lookup path -------------------------------------------------------

    def _maybe_sweep(self) -> None:
        """Every 256th lookup, at most once per ``sweep_min_interval_s``,
        one ``maintain()`` on a daemon thread (one in flight at a time; the
        flag is advisory: a duplicate sweep is wasted work, never wrong)."""
        if self.index.lookups % 256 or self._maintaining:
            return
        now = time.monotonic()
        if now - self._last_sweep < self.sweep_min_interval_s:
            return
        self._maintaining = True
        self._last_sweep = now

        def _sweep():
            try:
                self.maintain()
            finally:
                self._maintaining = False

        threading.Thread(target=_sweep, daemon=True).start()

    def try_intersect(self, classed) -> np.ndarray | None:
        """The host ``uint64`` words of an all-equality selector resolved
        from staged bitmaps, or None when a matcher is not an equality, is
        unstaged or stale (the host path resolves it). Caller holds the
        index lock."""
        from ..ops.postings_kernels import device_words_to_host, intersect_words

        idx = self.index
        self._maybe_sweep()
        if not classed or any(c != "eq" or f.value == "" for f, c in classed):
            return None
        entries = []
        for f, _c in classed:
            L = idx._labels.get(f.column)
            if L is None:
                return None
            with self._lock:
                e = self._staged.get((f.column, f.value))
            if e is None:
                self.stats["host_fallbacks"] += 1
                return None
            if e.post_version != L.post_version:
                # the postings moved under the staged copy: drop it
                self.drop((f.column, f.value), reason="invalidate")
                self.stats["host_fallbacks"] += 1
                return None
            e.hits += 1
            entries.append(e)
        if len(entries) == 1:
            out = device_words_to_host(entries[0].dev)
        else:
            # maintain() stages every bitmap at the universe's width, but a
            # label the universe's growth left untouched keeps its version
            # and its narrower copy: the host resolves such a mix
            if len({e.dev.shape[0] for e in entries}) != 1:
                self.stats["host_fallbacks"] += 1
                return None
            out = device_words_to_host(intersect_words([e.dev for e in entries]))
        self.stats["intersections"] += 1
        return out

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            entries = [{"label": k[0], "value": k[1], "bytes": e.nbytes, "hits": e.hits}
                       for k, e in sorted(self._staged.items())]
        return {
            "staged": entries,
            "staged_bytes": sum(e["bytes"] for e in entries),
            "ledger_bytes": self.ledger.bytes,
            "stats": dict(self.stats),
        }
