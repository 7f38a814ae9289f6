"""Learned per-query cost model: predicted device-seconds per fingerprint
(counterpart of ``filodb_tpu/query/costmodel.py``).

The scheduling plane prices work in device-seconds, not query counts. Per
normalized PromQL fingerprint (``promql_fingerprint``: dataset + query
text + grid shape, the live edge normalized away) it keeps an EWMA of
realized device-seconds and a unit cost (device-seconds per series x step),
updated from every completed query's record. Cold fingerprints are priced
by the family's unit cost scaled by the query's grid work and a safety
multiplier; with no family evidence either, the flat prior applies -- the
same constant that converts legacy query-count quotas into device-second
buckets, so an unconfigured deployment behaves exactly as before.

A record's realized cost is ``QueryStats.kernel_ns``: the host wall of
the query's kernel launches, with no device sync (the JAX package's
``record_kernel_dispatch``). A record without any is skipped: the JAX
package backs it with its executable registry's warm p50, which is the
query log's plane (ROADMAP A6).

Consumers: ``AdmissionController`` drains a tenant's bucket by the
prediction, and ``DispatchScheduler`` sizes its adaptive batch window from
the decayed sum of predicted queue cost.
"""

from __future__ import annotations

import hashlib
import re
import threading
from collections import OrderedDict

from ..metrics import REGISTRY

# what one typical query is worth in device-seconds before any evidence;
# also the legacy-quota conversion rate (N queries/s -> N * prior dev-s/s)
DEFAULT_PRIOR_COST_S = 0.05
# cold-fingerprint predictions are scaled up: over-pricing an unknown query
# sheds it a little early, under-pricing drains another tenant's quota
DEFAULT_COLD_MULTIPLIER = 2.0
DEFAULT_ALPHA = 0.3

_RANGE_FN = re.compile(r"\b([a-z_0-9]+_over_time|rate|irate|increase|delta"
                       r"|idelta|changes|resets|deriv)\s*\(")


def promql_fingerprint(dataset: str, promql: str, step_ms: int, span_ms: int) -> str:
    """Stable fingerprint of the normalized query: dataset + PromQL text +
    grid shape (step, span), the sliding start/end normalized away (the JAX
    package's ``obs/querylog.promql_fingerprint``)."""
    raw = f"{dataset}\x00{promql}\x00{int(step_ms)}\x00{int(span_ms)}"
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def family_of(promql: str) -> str:
    """Coarse workload family of a query: the outermost range function
    (``rate``, ``min_over_time``, ...) or ``instant``."""
    m = _RANGE_FN.search(promql or "")
    return m.group(1) if m else "instant"


class CostModel:
    """Online device-second predictor, keyed by fingerprint with a
    per-family fallback (fingerprint EWMA -> family unit cost x grid work ->
    flat prior). Thread-safe; all state is O(max_entries)."""

    def __init__(self, prior_cost_s: float = DEFAULT_PRIOR_COST_S,
                 alpha: float = DEFAULT_ALPHA,
                 cold_multiplier: float = DEFAULT_COLD_MULTIPLIER,
                 max_entries: int = 4096):
        self.prior_cost_s = max(float(prior_cost_s), 1e-6)
        self.alpha = min(max(float(alpha), 0.01), 1.0)
        self.cold_multiplier = max(float(cold_multiplier), 1.0)
        self._max = max(int(max_entries), 16)
        self._lock = threading.Lock()
        self._fp: OrderedDict[str, dict] = OrderedDict()
        self._families: dict[str, dict] = {}
        self._sources = {"fingerprint": 0, "family": 0, "prior": 0}
        self._observed = 0

    def configure(self, prior_cost_s: float | None = None, alpha: float | None = None,
                  cold_multiplier: float | None = None,
                  max_entries: int | None = None) -> None:
        with self._lock:
            if prior_cost_s is not None:
                self.prior_cost_s = max(float(prior_cost_s), 1e-6)
            if alpha is not None:
                self.alpha = min(max(float(alpha), 0.01), 1.0)
            if cold_multiplier is not None:
                self.cold_multiplier = max(float(cold_multiplier), 1.0)
            if max_entries is not None:
                self._max = max(int(max_entries), 16)
                while len(self._fp) > self._max:
                    self._fp.popitem(last=False)

    def predict(self, fingerprint: str, steps: int = 0, series: int = 0,
                family: str | None = None) -> tuple[float, str]:
        """Predicted device-seconds of one execution of ``fingerprint`` and
        the evidence tier that priced it (``fingerprint`` | ``family`` |
        ``prior``); ``steps`` x ``series`` scale a family's unit cost."""
        work = max(int(steps), 1) * max(int(series), 1)
        with self._lock:
            e = self._fp.get(fingerprint)
            if e is not None and e["n"] > 0:
                self._fp.move_to_end(fingerprint)
                self._sources["fingerprint"] += 1
                return max(e["cost_s"], 1e-9), "fingerprint"
            fam = self._families.get(family or "")
            if fam is not None and fam["n"] > 0:
                self._sources["family"] += 1
                if work > 1 and fam["unit_cost_s"] > 0.0:
                    cost = fam["unit_cost_s"] * work
                else:
                    cost = fam["cost_s"]
                return max(cost * self.cold_multiplier, 1e-9), "family"
            self._sources["prior"] += 1
            return self.prior_cost_s, "prior"

    def observe(self, record: dict) -> None:
        """Fold one completed query record (``fingerprint``, ``promql``,
        ``status``, ``realized_cost_s``, ``predicted_cost_s``,
        ``grid.steps``, ``stats.series_scanned``) into the model. A shed
        record or one without a realized cost changes nothing."""
        if not isinstance(record, dict) or record.get("status") == "shed":
            return
        fp = record.get("fingerprint")
        if not fp:
            return
        realized = float(record.get("realized_cost_s") or 0.0)
        if realized <= 0.0:
            return
        stats = record.get("stats") or {}
        grid = record.get("grid") or {}
        steps = int(grid.get("steps") or 1)
        series = int(stats.get("series_scanned") or 0)
        work = max(steps, 1) * max(series, 1)
        fam_key = family_of(record.get("promql", ""))
        predicted = record.get("predicted_cost_s")
        a = self.alpha
        with self._lock:
            self._observed += 1
            e = self._fp.get(fp)
            if e is None:
                e = {"cost_s": realized, "unit_cost_s": realized / work,
                     "n": 0, "family": fam_key, "last_predicted_s": None,
                     "last_realized_s": None, "last_error_ratio": None}
                self._fp[fp] = e
                while len(self._fp) > self._max:
                    self._fp.popitem(last=False)
            else:
                e["cost_s"] += a * (realized - e["cost_s"])
                e["unit_cost_s"] += a * (realized / work - e["unit_cost_s"])
            e["n"] += 1
            e["family"] = fam_key
            e["last_realized_s"] = realized
            self._fp.move_to_end(fp)
            fam = self._families.setdefault(fam_key, {"unit_cost_s": 0.0, "cost_s": 0.0, "n": 0})
            if fam["n"] == 0:
                fam["cost_s"] = realized
                fam["unit_cost_s"] = realized / work
            else:
                fam["cost_s"] += a * (realized - fam["cost_s"])
                fam["unit_cost_s"] += a * (realized / work - fam["unit_cost_s"])
            fam["n"] += 1
            if predicted is not None and predicted > 0.0:
                ratio = max(predicted / realized, realized / predicted)
                e["last_predicted_s"] = float(predicted)
                e["last_error_ratio"] = round(ratio, 4)
        if predicted is not None and predicted > 0.0:
            REGISTRY.histogram("filodb_costmodel_error_ratio").observe(
                max(predicted / realized, realized / predicted))

    def error_ratio(self, fingerprint: str) -> float | None:
        """The last prediction's symmetric error ratio (>= 1) of
        ``fingerprint``, None until a predicted record completes."""
        with self._lock:
            e = self._fp.get(fingerprint)
            return e["last_error_ratio"] if e else None

    def snapshot(self, limit: int = 64) -> dict:
        """Predictions and realized errors per warm fingerprint (newest
        first), family priors, and which evidence tier priced queries."""
        with self._lock:
            fps = [
                {"fingerprint": fp, **{k: (round(v, 6) if isinstance(v, float) else v)
                                       for k, v in e.items()}}
                for fp, e in list(self._fp.items())[-max(int(limit), 0):]
            ][::-1]
            return {
                "prior_cost_s": self.prior_cost_s,
                "alpha": self.alpha,
                "cold_multiplier": self.cold_multiplier,
                "observed": self._observed,
                "prediction_sources": dict(self._sources),
                "families": {
                    k: {"unit_cost_s": round(v["unit_cost_s"], 9),
                        "cost_s": round(v["cost_s"], 6), "n": v["n"]}
                    for k, v in sorted(self._families.items())
                },
                "fingerprints": fps,
            }

    def clear(self) -> None:
        with self._lock:
            self._fp.clear()
            self._families.clear()
            self._sources = {"fingerprint": 0, "family": 0, "prior": 0}
            self._observed = 0


COST_MODEL = CostModel()
