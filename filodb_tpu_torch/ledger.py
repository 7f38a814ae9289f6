"""Device-resource ledger of the port (counterpart of ``filodb_tpu/ledger.py``):
one accounting object every device-memory consumer debits and credits.

Consumers register an *account* per cache -- each shard's staging cache
(kind ``staged_block``: its host-staged blocks and the device copies tree
leaves read) and the memstore's ``SuperblockCache`` (kind ``superblock``)
-- with:

- a ``kind`` label, the ``filodb_device_bytes{kind=...}`` dimension;
- a *walker*: a function recomputing the owner's true footprint from the
  cache itself (``staging.staged_nbytes`` over live entries). ``verify()``
  compares every live account's running balance against a cold walk: the
  drift check ``/debug/resources`` serves, which must read zero;
- a *device walker*: the same bytes split by the device they lie on
  (``cpu`` for a host-staged block, ``cuda:0`` for the card), published as
  ``filodb_device_bytes{kind, device}``.

Accounts hold their owner only through a weakref, so a shut-down
memstore's caches are not pinned by the process-global ledger; an account
collected while still holding bytes counts them in
``filodb_device_leaked_bytes_total{kind}``.

Balances come from ``.nbytes`` and the walkers read ``.nbytes`` only, so
accounting adds no host sync: a warm fused query stays one launch.
"""

from __future__ import annotations

import threading
import time
import weakref

from .metrics import REGISTRY


class LedgerAccount:
    """One consumer's balance within the ledger. ``alloc``/``free`` are the
    debit/credit pair."""

    __slots__ = ("kind", "name", "_owner_ref", "_walker", "_device_walker", "_lock",
                 "bytes", "allocs", "frees", "created")

    def __init__(self, kind: str, name: str, owner_ref, walker, device_walker=None):
        self.kind = kind
        self.name = name
        self._owner_ref = owner_ref
        self._walker = walker
        self._device_walker = device_walker
        self._lock = threading.Lock()
        self.bytes = 0
        self.allocs = 0
        self.frees = 0
        self.created = time.time()

    def alloc(self, nbytes: int, count: int = 1) -> None:
        if nbytes <= 0 and count <= 0:
            return
        with self._lock:
            self.bytes += int(nbytes)
            self.allocs += count
        REGISTRY.counter("filodb_device_alloc", kind=self.kind).inc(count)
        REGISTRY.counter("filodb_device_alloc_bytes", kind=self.kind).inc(int(nbytes))

    def free(self, nbytes: int, reason: str = "drop", count: int = 1) -> None:
        """Credit released bytes. ``reason``: ``evict`` (budget eviction),
        ``invalidate`` (ingest invalidation / wholesale clear), ``replace``
        (entry superseded by a rebuild/repair), ``drop`` (explicit
        removal)."""
        if nbytes <= 0 and count <= 0:
            return
        with self._lock:
            self.bytes -= int(nbytes)
            self.frees += count
        REGISTRY.counter("filodb_device_free", kind=self.kind, reason=reason).inc(count)
        REGISTRY.counter(
            "filodb_device_free_bytes", kind=self.kind, reason=reason
        ).inc(int(nbytes))

    def walk(self) -> int | None:
        """Cold recount of the owner's true footprint (None when the owner
        is gone or has no walker)."""
        if self._walker is None:
            return None
        owner = self._owner_ref() if self._owner_ref is not None else None
        if self._owner_ref is not None and owner is None:
            return None
        try:
            return int(self._walker(owner) if self._owner_ref is not None
                       else self._walker())
        except Exception:  # noqa: BLE001 — a sick walker must not kill /metrics
            return None

    def walk_devices(self) -> dict | None:
        """Per-device byte split of this account's balance (None when the
        owner is gone or the account has no device walker). Metadata-only,
        like walk()."""
        if self._device_walker is None:
            return None
        owner = self._owner_ref() if self._owner_ref is not None else None
        if self._owner_ref is not None and owner is None:
            return None
        try:
            return self._device_walker(owner)
        except Exception:  # noqa: BLE001 — a sick walker must not kill /metrics
            return None

    def alive(self) -> bool:
        return self._owner_ref is None or self._owner_ref() is not None


class DeviceLedger:
    """Process-global registry of LedgerAccounts; exposes the per-kind
    ``filodb_device_bytes`` gauges as a scrape-time collector and serves
    the drift check (``verify``) behind ``/debug/resources``."""

    KINDS = ("staged_block", "superblock")

    def __init__(self):
        self._lock = threading.Lock()
        self._accounts: dict[int, LedgerAccount] = {}
        self._next_id = 0
        self._seen_kinds: set[str] = set(self.KINDS)
        self._seen_devices: set[tuple[str, str]] = set()
        # dead-owner notices: weakref callbacks run mid-GC (possibly inside
        # OTHER locks), so they only append to this list — list.append is
        # atomic under the GIL — and real cleanup happens lazily in _reap()
        self._dead: list[tuple[int, str, int]] = []

    def register(self, owner, kind: str, walker=None, name: str = "",
                 device_walker=None) -> LedgerAccount:
        """Create an account for ``owner`` (held weakly). ``walker(owner)``
        recomputes the true byte footprint for the drift check.
        ``device_walker(owner)`` optionally returns a per-device byte split
        published as ``filodb_device_bytes{kind,device}``."""
        with self._lock:
            aid = self._next_id
            self._next_id += 1
        acct_holder: list[LedgerAccount] = []

        def on_dead(_ref, _aid=aid):
            acct = acct_holder[0] if acct_holder else None
            self._dead.append((_aid, kind, acct.bytes if acct is not None else 0))

        ref = weakref.ref(owner, on_dead) if owner is not None else None
        acct = LedgerAccount(kind, name, ref, walker, device_walker=device_walker)
        acct_holder.append(acct)
        with self._lock:
            self._accounts[aid] = acct
        return acct

    def _reap(self) -> None:
        """Lazily process dead-owner notices: drop their accounts and count
        any unreleased balance as leaked bytes."""
        while self._dead:
            try:
                aid, kind, leaked = self._dead.pop()
            except IndexError:  # racer drained it
                return
            with self._lock:
                self._accounts.pop(aid, None)
            if leaked > 0:
                REGISTRY.counter("filodb_device_leaked_bytes", kind=kind).inc(leaked)

    def _live_accounts(self) -> list[LedgerAccount]:
        self._reap()
        with self._lock:
            accts = list(self._accounts.values())
        return [a for a in accts if a.alive()]

    def balances(self) -> dict[str, int]:
        """Per-kind byte balance over live accounts."""
        out: dict[str, int] = {}
        for a in self._live_accounts():
            out[a.kind] = out.get(a.kind, 0) + a.bytes
        return out

    def verify(self) -> dict:
        """Drift check: ledger balance vs a cold walk of every live cache.
        Returns ``{"kinds": {kind: {"ledger": b, "actual": b, "drift": d}},
        "accounts": [...]}`` — drift must be zero."""
        kinds: dict[str, dict] = {}
        accounts = []
        for a in self._live_accounts():
            actual = a.walk()
            slot = kinds.setdefault(a.kind, {"ledger": 0, "actual": 0, "drift": 0})
            slot["ledger"] += a.bytes
            if actual is not None:
                slot["actual"] += actual
                slot["drift"] += a.bytes - actual
            accounts.append({
                "kind": a.kind,
                "name": a.name,
                "bytes": a.bytes,
                "actual": actual,
                "allocs": a.allocs,
                "frees": a.frees,
            })
        return {"kinds": kinds, "accounts": accounts}

    def device_balances(self) -> dict[tuple[str, str], int]:
        """Per-(kind, device) byte balances over live accounts that expose a
        device split."""
        out: dict[tuple[str, str], int] = {}
        for a in self._live_accounts():
            split = a.walk_devices()
            if not split:
                continue
            for dev, b in split.items():
                key = (a.kind, str(dev))
                out[key] = out.get(key, 0) + int(b)
        return out

    def publish(self) -> None:
        """Scrape-time collector: refresh the per-kind gauges and their
        per-device breakdown. Kinds/devices seen once keep publishing
        (possibly 0) so dashboards don't see series vanish when a cache
        empties."""
        balances = self.balances()
        self._seen_kinds |= set(balances)
        for kind in self._seen_kinds:
            REGISTRY.gauge("filodb_device_bytes", kind=kind).set(
                float(balances.get(kind, 0))
            )
        dev_balances = self.device_balances()
        self._seen_devices |= set(dev_balances)
        for kind, dev in self._seen_devices:
            REGISTRY.gauge("filodb_device_bytes", kind=kind, device=dev).set(
                float(dev_balances.get((kind, dev), 0))
            )


LEDGER = DeviceLedger()
REGISTRY.register_collector("device_ledger", LEDGER.publish)
