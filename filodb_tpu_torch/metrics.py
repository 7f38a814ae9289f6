"""Process-wide event counters (counterpart of the superblock part of
``filodb_tpu/metrics.py``). The JAX package exposes them in Prometheus'
text format; the port keeps a plain dict that tests and ``chip_smoke.py``
read.
"""

from __future__ import annotations

import threading

SUPERBLOCK_OUTCOMES = ("revalidate", "extend", "extend_abort", "restage")

# outcome -> count of version-stale superblock maintenance events
SUPERBLOCK_EVENTS: dict[str, int] = dict.fromkeys(SUPERBLOCK_OUTCOMES, 0)
_LOCK = threading.Lock()


def record_superblock_event(outcome: str) -> None:
    """Count one maintenance outcome of a version-stale cached superblock:

    - ``revalidate``: the ingest since the entry was built was provably
      disjoint from its range; the entry was re-stamped and served as is;
    - ``extend``: overlapping live-edge appends were absorbed by extending
      the superblock;
    - ``extend_abort``: an extension raced a conflicting ingest and was
      discarded;
    - ``restage``: the extension's preconditions failed; a full rebuild."""
    if outcome not in SUPERBLOCK_EVENTS:
        raise ValueError(f"unknown superblock outcome {outcome!r}")
    with _LOCK:
        SUPERBLOCK_EVENTS[outcome] += 1


def superblock_events() -> dict[str, int]:
    """A snapshot of the counts (callers read differences between two)."""
    with _LOCK:
        return dict(SUPERBLOCK_EVENTS)
