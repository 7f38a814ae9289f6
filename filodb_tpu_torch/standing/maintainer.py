"""Standing-query maintainer (counterpart of ``filodb_tpu/standing/maintainer.py``):
dashboards kept by delta refreshes, and recording rules.

``StandingEngine`` sits between the dispatch scheduler and the fused
engine and owns:

- **promotion**: ``promote_tick`` scans the scheduler's recurrence ring
  (``query/scheduler.KeyStatsRing``, fed by every fused dispatch) and
  registers hot live-edge keys, with hysteresis: promotion needs a burst
  (``promote_min_count`` recurrences within ``promote_window_s``),
  demotion a long idle (``demote_idle_s``) with no subscriber.
  Nondecomposable epilogues are remembered as demoted, so the promoter
  never flaps on them.
- **delta maintenance**: each registered query keeps its ``[G, J]``
  partials. A refresh reads what ingest did since they were computed from
  the shards' effect logs (``ingest_effects_interval_since``): nothing in
  range serves the retained partials with no dispatch; a live-edge append
  re-dispatches only the step suffix whose windows reach the appended
  interval, through the same fused launch over the same superblock (which
  extends in place under the append, ``staging.extend_superblock``), and
  splices it in (``aggregations.splice_partials``). On the CPU the
  spliced partials equal a full re-evaluation bit for bit; on the card
  group atomics add in launch order, so sums agree within rounding.
  Epilogues that cannot splice per step (topk, quantile, the fused
  histogram_quantile) re-dispatch the whole grid, counted
  ``filodb_fused_fallback_total{reason="standing_nondecomposable"}``.
- **push**: each refresh renders its payload once and the
  ``SubscriptionHub`` hands the same bytes to every SSE subscriber
  (``/api/v1/standing/subscribe``).
- **recording rules**: a query with a ``rule_name`` writes its newest
  closed steps back into the memstore as ``rule_name{group labels}``;
  one with an ``alert_sink`` hands the newest closed step's column to it
  after every refresh, outside the query's lock.

Refreshes bypass admission (they are the server's own standing work) but
are attributed: the owning tenant pays through the
``filodb_tenant_*_total`` counters, and retained partials are the device
ledger's kind ``standing_state``. The JAX package also writes a query-log
record per refresh; the query log is ROADMAP A6.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time

import numpy as np

from ..metrics import REGISTRY, record_fused_fallback
from .hub import SubscriptionHub
from .registry import StandingQuery, StandingRegistry, _new_qid

log = logging.getLogger("filodb_tpu_torch.standing")

DEFAULTS = {
    "enabled": True,
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
    # answer a query_range that matches a registered query from its
    # retained matrix
    "serve_range": True,
}


def rfc3339(ms: int) -> str:
    """The Prometheus API's timestamp; ``ms <= 0`` is its zero time."""
    if ms <= 0:
        return "0001-01-01T00:00:00Z"
    t = time.gmtime(ms / 1000.0)
    return (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}"
            f"T{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}.{int(ms % 1000):03d}Z")


class StandingEngine:
    """Registry, maintainer, promoter and hub, bound to one QueryEngine."""

    def __init__(self, engine, config: dict | None = None, hub=None, clock=time.time):
        cfg = {**DEFAULTS, **(config or {})}
        self.cfg = cfg
        self.engine = engine
        self.dataset = engine.dataset
        self.clock = clock
        # batching may be off (window 0): the scheduler still exists so that
        # its recurrence ring sees every fused dispatch
        self.scheduler = engine.dispatch_scheduler_for_ring(key_ring_max=int(cfg["key_ring_max"]))
        self.registry = StandingRegistry(int(cfg["max_standing"]))
        self.hub = hub or SubscriptionHub(int(cfg["max_subscribers"]))
        self.align_ms = int(cfg["align_ms"])
        self.debounce_s = float(cfg["refresh_debounce_ms"]) / 1e3
        # qid -> {(cache, superblock key)} pinned for that query; reconciled
        # after each dispatch, so a rolled staging range unpins its old key
        self._sb_pins: dict[str, set] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._listening: list = []  # (shard, callback) pairs to remove at stop

    # -- registration ------------------------------------------------------

    def register(self, promql: str, step_ms: int, span_ms: int | None = None,
                 source: str = "manual", key=None, rule_name: str | None = None,
                 eval_interval_s: float | None = None, alert_sink=None) -> StandingQuery:
        """Register one standing query. Its maintenance mode comes from the
        planned exec: ``delta`` (a fused aggregate whose epilogue splices)
        or ``full`` (an epilogue that does not, or a plan the fused engine
        does not serve: every refresh re-dispatches). Raises on PromQL that
        does not parse and on a full registry."""
        from ..ops import aggregations as AGG
        from ..query.exec.plans import FusedAggregateExec

        step_ms = max(int(step_ms), 1)
        span_ms = int(span_ms if span_ms else self.cfg["default_span_ms"])
        span_ms = max(span_ms - span_ms % step_ms, step_ms)
        now_ms = int(self.clock() * 1000)
        end = now_ms - now_ms % step_ms
        ex, tenant = self._materialize(promql, end - span_ms, end, step_ms)
        mode, mode_reason = "full", "not_fused"
        window_ms = offset_ms = 0
        if isinstance(ex, FusedAggregateExec):
            window_ms, offset_ms = ex.window_ms, ex.offset_ms
            if AGG.standing_delta_eligible(ex.op, ex.params, ex.hist_quantile):
                mode, mode_reason = "delta", None
            else:
                mode_reason = "standing_nondecomposable"
        sq = StandingQuery(
            qid=_new_qid(), promql=promql, dataset=self.dataset, step_ms=step_ms,
            span_ms=span_ms, source=source, key=key, mode=mode, mode_reason=mode_reason,
            ws=tenant[0], ns=tenant[1], rule_name=rule_name, eval_interval_s=eval_interval_s,
            alert_sink=alert_sink, window_ms=window_ms, offset_ms=offset_ms)
        self.registry.add(sq)
        if key is not None:
            self.registry.forget_demoted(key)
        REGISTRY.counter("filodb_standing_promotions",
                         event="promote" if source == "promoted" else "register").inc()
        self._wake.set()
        return sq

    def unregister(self, qid: str, reason: str = "unregistered"):
        sq = self.registry.remove(qid)
        if sq is None:
            return None
        self._sb_pins.pop(qid, None)
        cache = getattr(self.engine.memstore, "_superblock_cache", None)
        if cache is not None:
            cache.unpin_owner(qid)
        self.hub.close(qid)
        if sq.source == "promoted":
            self.registry.note_demoted(sq.key, reason)
        REGISTRY.counter("filodb_standing_promotions", event="demote").inc()
        return sq

    def get(self, qid: str) -> StandingQuery | None:
        return self.registry.get(qid)

    # -- refresh (the delta path) ------------------------------------------

    def _materialize(self, promql: str, start_ms: int, end_ms: int, step_ms: int):
        """(exec plan, (ws, ns)) of one evaluation grid."""
        from ..metering import tenant_of_plan
        from ..query.promql import query_range_to_logical_plan

        plan = query_range_to_logical_plan(promql, start_ms / 1000.0, end_ms / 1000.0,
                                           step_ms / 1000.0,
                                           self.engine.planner.params.lookback_ms)
        return self.engine.planner.materialize(plan), tenant_of_plan(plan)

    @staticmethod
    def _pin_raw_range(ex, aligned: tuple) -> None:
        """Stage a fused exec over the query's aligned range, so every
        refresh resolves to one superblock cache entry, the one live-edge
        appends extend in place (a wider staged range is safe: windows come
        from the query's grid)."""
        ex.raw_start_ms, ex.raw_end_ms = aligned

    def _aligned_raw(self, ex) -> tuple:
        """The staging range quantized: the start floored to ``align_ms``,
        the end floored and two periods added, at least one period of
        live-edge headroom, so the range (the superblock key and the
        retained partials with it) holds while the grid end moves within one
        period. The range rolls, and the state resets, once per
        ``align_ms``; every refresh between is a delta or retained."""
        a = self.align_ms
        return (ex.raw_start_ms - ex.raw_start_ms % a, ex.raw_end_ms - ex.raw_end_ms % a + 2 * a)

    def _execute(self, ex, owner: str | None = None):
        """Run one (suffix or full) dispatch on an engine context: no
        admission (standing work is the server's own), kept out of the
        recurrence ring, the superblock key it resolves to pinned for
        ``owner``. Returns (context, result)."""
        ctx = self.engine.context()
        ctx.standing_refresh = True
        pinned: list = []
        if owner is not None:
            def _pin(cache, key, _o=owner, _l=pinned):
                cache.pin(key, _o)
                _l.append((cache, key))

            ctx.superblock_pin_sink = _pin
        res = ex.execute(ctx)
        if owner is not None and pinned:
            # the new pins are held already: dropping the ones this dispatch
            # did not touch leaves no gap
            new = set(pinned)
            for cache, key in self._sb_pins.get(owner, set()) - new:
                cache.unpin(key, owner)
            self._sb_pins[owner] = new
        return ctx, res

    def refresh(self, sq: StandingQuery, now_ms: int | None = None,
                force_full: bool = False) -> bytes | None:
        """One refresh: classify the ingest since the retained partials,
        re-dispatch the least step suffix (or nothing), splice, render once,
        fan out, write rule series back. Returns the rendered payload (None
        when nothing changed or the refresh failed)."""
        from ..metering import record_tenant_query

        t0 = time.perf_counter()
        if now_ms is None:
            now_ms = int(self.clock() * 1000)
        with sq.lock:
            if sq.removed:
                return None  # the unregister won: its ledger credit is final
            try:
                payload, outcome, ctx, evalv = self._refresh_locked(sq, now_ms, force_full)
            except Exception as e:  # noqa: BLE001 -- maintenance must outlive a bad refresh
                sq.stats["errors"] += 1
                sq.last_error = f"{type(e).__name__}: {e}"
                REGISTRY.counter("filodb_standing_refreshes", outcome="error").inc()
                if sq.alert_sink is not None:
                    REGISTRY.counter("filodb_alert_eval_failures",
                                     rule=getattr(sq.alert_sink, "rule", "unknown")).inc()
                log.exception("standing refresh failed: %s", sq.promql)
                return None
            sq.last_error = None
        elapsed = time.perf_counter() - t0
        sq.last_eval_duration_s = elapsed
        REGISTRY.counter("filodb_standing_refreshes", outcome=outcome).inc()
        REGISTRY.histogram("filodb_standing_refresh_seconds").observe(elapsed)
        if ctx is not None:
            record_tenant_query(sq.ws, sq.ns, elapsed, ctx.stats.kernel_ns / 1e9,
                                ctx.stats.bytes_staged)
        if payload is not None:
            self.hub.publish(sq.qid, payload)
        if sq.alert_sink is not None and evalv is not None:
            # outside sq.lock: the sink may ingest, which wakes the listeners
            try:
                sq.alert_sink(sq, evalv[0], evalv[1])
            except Exception:  # noqa: BLE001 -- a failing sink must not end the refresh
                log.exception("alert sink failed: %s", sq.promql)
        return payload

    def _refresh_locked(self, sq: StandingQuery, now_ms: int, force_full: bool):
        from ..ops import aggregations as AGG
        from ..query.exec.plans import FusedAggregateExec

        step = sq.step_ms
        end = now_ms - now_ms % step
        start = end - sq.span_ms
        J = (end - start) // step + 1
        if sq.mode != "delta":
            return self._refresh_full(sq, start, end, J)
        ex, _tenant = self._materialize(sq.promql, start, end, step)
        if not isinstance(ex, FusedAggregateExec):
            # the plan stopped fusing (a config change): full mode, and the
            # delta state goes (full refreshes never read it)
            sq.mode, sq.mode_reason = "full", "not_fused"
            self._drop_state(sq)
            return self._refresh_full(sq, start, end, J)
        aligned = self._aligned_raw(ex)
        self._pin_raw_range(ex, aligned)
        shard_nums = tuple(ex.shard_nums)
        memstore = self.engine.memstore
        # read before the dispatch: whatever lands during it is dirt for
        # the next refresh (never stale)
        versions_now = tuple(memstore.shard(sq.dataset, s).version for s in shard_nums)
        reset = (force_full or sq.retained is None or sq.versions is None
                 or sq.raw_range != aligned or sq.shard_nums != shard_nums
                 or len(sq.versions) != len(shard_nums))
        dirty_lo = None
        if not reset:
            for s, vold in zip(shard_nums, sq.versions):
                reason, lo, _hi = memstore.shard(sq.dataset, s).ingest_effects_interval_since(
                    vold, aligned[0], aligned[1])
                if reason in ("full_clear", "log_truncated"):
                    reset = True
                    break
                if reason == "overlap":
                    dirty_lo = lo if dirty_lo is None else min(dirty_lo, lo)
        retained = None
        k0 = 0
        if not reset:
            shift = (start - sq.grid_start_ms) // step
            if shift < 0:
                reset = True  # the clock went back: the state is ahead of now
            else:
                retained = AGG.shift_partials(sq.retained, int(shift), J)
                # the first new step (past the old grid end)
                k_new = min(max(int((sq.grid_end_ms - start) // step + 1), 0), J)
                # the first step whose window (out_t - offset - w, out_t -
                # offset] can hold an appended sample: out_t >= dirty_lo + offset
                k_dirty = J
                if dirty_lo is not None:
                    k_dirty = min(max(int(math.ceil((dirty_lo + sq.offset_ms - start) / step)),
                                      0), J)
                k0 = min(k_new, k_dirty)
        if reset:
            k0, retained = 0, None
        ctx = None
        if k0 >= J and retained is not None:
            # fully warm: what landed (if anything) misses every window and
            # the grid did not move, so the content equals the last
            # refresh's: no dispatch, no render, no push; only the version
            # vector commits
            sq.versions = versions_now
            sq.stats["refreshes"] += 1
            sq.stats["retained"] += 1
            sq.stats["steps_retained"] += J
            REGISTRY.counter("filodb_standing_steps", kind="retained").inc(J)
            sq.last_refresh_s = self.clock()
            evalv = (self._eval_col(sq.retained, sq.labels, sq.grid_end_ms)
                     if sq.alert_sink is not None else None)
            return None, "retained", None, evalv
        if k0 > 0:
            # the delta dispatch: only the touched suffix, through the same
            # fused launch over the same superblock
            ex_d, _t = self._materialize(sq.promql, start + k0 * step, end, step)
            if isinstance(ex_d, FusedAggregateExec):
                self._pin_raw_range(ex_d, aligned)
            else:  # the plan changed shape underfoot: the whole grid
                ex_d, k0 = ex, 0
        else:
            ex_d = ex
        ctx, res = self._execute(ex_d, owner=sq.qid)
        fresh, fresh_labels = self._grid_arrays(res, J - k0)
        if k0 > 0 and sq.labels != fresh_labels:
            # the group set changed (a restage with other series raced the
            # classification): the halves would disagree on the group axis,
            # so the whole grid runs; the discarded dispatch still counts
            prev = ctx
            ctx, res = self._execute(ex, owner=sq.qid)
            ctx.stats.merge(prev.stats)
            fresh, fresh_labels = self._grid_arrays(res, J)
            k0, retained = 0, None
        if k0 > 0:
            retained = AGG.splice_partials(retained, fresh, k0)
            labels = sq.labels
            outcome = "delta"
        else:
            retained, labels = fresh, fresh_labels
            outcome = "reset" if reset else "full"
        sq.stats[outcome] += 1
        sq.stats["steps_computed"] += J - k0
        sq.stats["steps_retained"] += k0
        REGISTRY.counter("filodb_standing_steps", kind="computed").inc(J - k0)
        if k0:
            REGISTRY.counter("filodb_standing_steps", kind="retained").inc(k0)
        old_nb = sq.state_nbytes()
        sq.retained, sq.labels = retained, labels
        sq.grid_start_ms, sq.grid_end_ms = start, end
        sq.raw_range = aligned
        sq.versions = versions_now
        sq.shard_nums = shard_nums
        sq.seq += 1
        sq.stats["refreshes"] += 1
        sq.last_refresh_s = self.clock()
        self.registry.account_state(old_nb, sq.state_nbytes())
        payload = self._render(sq, start, J, retained, labels or [])
        if sq.rule_name:
            self._write_rule(sq, start, end, J, retained, labels or [])
        evalv = self._eval_col(retained, labels, end) if sq.alert_sink is not None else None
        return payload, outcome, ctx, evalv

    def _drop_state(self, sq: StandingQuery) -> None:
        """Release a query's delta state (the caller holds sq.lock)."""
        nb = sq.state_nbytes()
        if nb:
            self.registry.account_state(nb, 0)
        sq.retained = sq.labels = sq.versions = sq.raw_range = None

    def _refresh_full(self, sq: StandingQuery, start: int, end: int, J: int):
        """A full re-dispatch, for queries that cannot splice or do not fuse:
        still registered and pushed, paying the whole grid each refresh
        (counted in the fused-fallback taxonomy when the epilogue is why)."""
        from ..api import promjson as PJ

        if sq.mode_reason == "standing_nondecomposable":
            record_fused_fallback("standing_nondecomposable")
        ex, _tenant = self._materialize(sq.promql, start, end, sq.step_ms)
        ctx, res = self._execute(ex, owner=sq.qid)
        sq.grid_start_ms, sq.grid_end_ms = start, end
        sq.seq += 1
        sq.stats["refreshes"] += 1
        sq.stats["full"] += 1
        sq.stats["steps_computed"] += J
        REGISTRY.counter("filodb_standing_steps", kind="computed").inc(J)
        sq.last_refresh_s = self.clock()
        payload = self._frame(sq, PJ.render_matrix(res))
        vals = labels = None
        if (sq.rule_name or sq.alert_sink is not None) and res.grids:
            vals, labels = self._grid_arrays(res, J)
        if sq.rule_name and res.grids:
            self._write_rule(sq, start, end, J, vals, labels)
        evalv = self._eval_col(vals, labels, end) if sq.alert_sink is not None else None
        return payload, "full", ctx, evalv

    @staticmethod
    def _eval_col(vals, labels, end_ms: int):
        """``(end_ms, [(labels, value), ...])`` of the newest closed step,
        the alert sink's input; NaN entries (absent series) are dropped, as
        absence is what resolves an alert."""
        vec = []
        if vals is not None and vals.size and labels:
            col = vals[:, -1]
            for gi, lbl in enumerate(labels):
                v = float(col[gi])
                if not math.isnan(v):
                    vec.append((dict(lbl), v))
        return (int(end_ms), vec)

    @staticmethod
    def _grid_arrays(res, num_steps: int):
        """(a [G, num_steps] float32 copy, the [G] labels) of a result; an
        empty selection is a grid of no groups."""
        if not res.grids:
            return np.zeros((0, num_steps), np.float32), []
        g = res.grids[0]
        vals = np.array(g.values_np(), dtype=np.float32, copy=True)
        if vals.shape[1] < num_steps:
            pad = np.full((vals.shape[0], num_steps - vals.shape[1]), np.nan, np.float32)
            vals = np.concatenate([vals, pad], axis=1)
        return vals[:, :num_steps], list(g.labels)

    def _render(self, sq: StandingQuery, start: int, J: int, retained, labels) -> bytes:
        """The one render of a refresh: every subscriber's frame (and the SSE
        stream's first frame) is this payload."""
        from ..api import promjson as PJ
        from ..query.rangevector import Grid, QueryResult

        vals = retained if retained is not None else np.zeros((0, J), np.float32)
        return self._frame(sq, PJ.render_matrix(QueryResult(
            grids=[Grid(list(labels), start, sq.step_ms, J, vals)])))

    @staticmethod
    def _frame(sq: StandingQuery, data: dict) -> bytes:
        """A refresh's payload (the rendered matrix with the query's id and
        sequence), kept as the SSE stream's first frame."""
        payload = json.dumps({"id": sq.qid, "seq": sq.seq, "dataset": sq.dataset,
                              **data}).encode()
        sq.last_payload = payload
        sq.stats["renders"] += 1
        return payload

    def _write_rule(self, sq: StandingQuery, start: int, end: int, J: int, vals,
                    labels) -> None:
        """Recording-rule write-back: the newest closed steps not yet written
        land as samples of ``rule_name{group labels}`` through the normal
        ingest path (the first evaluation writes the newest step only)."""
        from ..core.records import gauge_batch
        from ..core.schemas import METRIC_TAG

        first = max(sq.last_rule_write_ms + sq.step_ms, start)
        if sq.last_rule_write_ms <= 0:
            first = end
        if first > end or vals is None or not len(labels):
            sq.last_rule_write_ms = max(sq.last_rule_write_ms, end)
            return
        recs = []
        for j in range((first - start) // sq.step_ms, J):
            t = start + j * sq.step_ms
            col = vals[:, j]
            for gi, lbl in enumerate(labels):
                v = float(col[gi])
                if not math.isnan(v):
                    tags = {k: v2 for k, v2 in dict(lbl).items()
                            if k not in (METRIC_TAG, "__name__")}
                    recs.append((tags, int(t), v))
        if recs:
            try:
                n = self.engine.memstore.ingest_routed(
                    sq.dataset, gauge_batch(sq.rule_name, recs),
                    spread=self.engine.planner.params.spread)
                REGISTRY.counter("filodb_standing_rule_samples").inc(n)
            except Exception:  # noqa: BLE001 -- a quota or cardinality shed
                log.exception("recording-rule write-back failed: %s", sq.rule_name)
        sq.last_rule_write_ms = end

    # -- serving a query_range from retained state ---------------------------

    def serve_range(self, promql: str, start_s: float, end_s: float, step_s: float):
        """Answer an ordinary ``query_range`` from a registered delta query's
        retained matrix: a QueryResult when one matches the PromQL and step
        and its grid covers the range on its phase, else None (the caller
        runs the engine). A grid behind the requested end refreshes first
        (a suffix, often no dispatch at all)."""
        from ..query.rangevector import Grid, QueryResult

        if not self.cfg.get("serve_range", True):
            return None
        t0 = time.perf_counter()
        step_ms = max(int(round(step_s * 1000)), 1)
        start_ms = int(round(start_s * 1000))
        end_ms = int(round(end_s * 1000))
        if start_ms % step_ms or (end_ms - start_ms) % step_ms:
            return None
        sq = next((c for c in self.registry.list() if c.promql == promql
                   and c.step_ms == step_ms and c.mode == "delta"), None)
        if sq is None:
            return None
        if sq.retained is None or end_ms > sq.grid_end_ms:
            self.refresh(sq)
        with sq.lock:
            if (sq.removed or sq.retained is None or sq.labels is None
                    or start_ms < sq.grid_start_ms or end_ms > sq.grid_end_ms
                    or (start_ms - sq.grid_start_ms) % step_ms):
                return None
            j0 = (start_ms - sq.grid_start_ms) // step_ms
            j1 = (end_ms - sq.grid_start_ms) // step_ms
            vals = np.array(sq.retained[:, j0:j1 + 1], copy=True)
            labels = [dict(lbl) for lbl in sq.labels]
        res = QueryResult(grids=[Grid(labels, start_ms, step_ms, j1 - j0 + 1, vals)])
        res.phases = {"standing": time.perf_counter() - t0}
        sq.stats["serves"] = sq.stats.get("serves", 0) + 1
        REGISTRY.counter("filodb_standing_serves").inc()
        return res

    # -- promotion / demotion ------------------------------------------------

    def promote_tick(self, now_s: float | None = None) -> int:
        """Scan the recurrence ring and register the keys that burst;
        returns how many."""
        from ..ops import aggregations as AGG

        if now_s is None:
            now_s = self.clock()
        cfg = self.cfg
        n_min = int(cfg["promote_min_count"])
        promoted = 0
        for key, e in self.scheduler.key_ring.entries():
            desc = e.get("desc") or {}
            promql = desc.get("promql")
            if not promql or desc.get("dataset") != self.dataset:
                continue
            if self.registry.by_key(key) is not None:
                continue
            reason = self.registry.demoted_reason(key)
            if reason == "standing_nondecomposable":
                continue
            if reason is not None:
                at = self.registry.demoted.get(key, {}).get("at_s", 0)
                if now_s - at < float(cfg["demote_retry_s"]):
                    continue
                self.registry.forget_demoted(key)
            recent = list(e["recent"])
            if len(recent) < n_min or recent[-1] - recent[-n_min] > float(
                    cfg["promote_window_s"]):
                continue
            if abs(desc.get("end_lag_ms", 1e18)) > float(cfg["promote_live_lag_ms"]):
                continue  # a historical scan, not a live-edge dashboard
            if not AGG.standing_delta_eligible(desc.get("op", ""), desc.get("params", ()),
                                               desc.get("hist_quantile")):
                self.registry.note_demoted(key, "standing_nondecomposable")
                record_fused_fallback("standing_nondecomposable")
                REGISTRY.counter("filodb_standing_promotions", event="demote").inc()
                continue
            if len(self.registry.list()) >= self.registry.max_standing:
                # capacity, not a property of the key: retry on a later tick
                log.warning("standing registry full; promotion of %s deferred", promql)
                continue
            try:
                self.register(promql, desc["step_ms"], span_ms=desc.get("span_ms"),
                              source="promoted", key=key)
                promoted += 1
            except Exception as exc:  # noqa: BLE001 -- unparseable or invalid
                log.warning("standing promotion failed for %s: %s", promql, exc)
                self.registry.note_demoted(key, "error")
        return promoted

    def demote_tick(self, now_s: float | None = None) -> int:
        """Unregister promoted queries whose recurrence went quiet and that
        nobody subscribes to (the idle bound is far above the promotion
        window, so the two never oscillate)."""
        if now_s is None:
            now_s = self.clock()
        idle_s = float(self.cfg["demote_idle_s"])
        demoted = 0
        for sq in self.registry.list():
            if sq.source != "promoted":
                continue
            e = self.scheduler.key_ring.get(sq.key)
            last = e["last_s"] if e is not None else sq.created_s
            if now_s - max(last, sq.created_s) <= idle_s or self.hub.count(sq.qid) > 0:
                continue
            self.unregister(sq.qid, reason="idle")
            demoted += 1
        return demoted

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # appends are wake signals only: the effect log decides at refresh
        for sh in self.engine.memstore.shards(self.dataset):
            sh.add_append_listener(self._on_append)
            self._listening.append((sh, self._on_append))
        self._thread = threading.Thread(target=self._run, daemon=True, name="filodb-standing")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for sh, cb in self._listening:
            sh.remove_append_listener(cb)
        self._listening.clear()
        if self._thread is not None:
            self._thread.join(timeout=2)
        for sq in self.registry.list():
            self.hub.close(sq.qid)

    def _on_append(self, _dataset, _shard, _lo, _hi, _full) -> None:
        self._wake.set()

    def _run(self) -> None:
        tick = float(self.cfg["tick_s"])
        last_promo = 0.0
        while not self._stop.is_set():
            woke = self._wake.wait(tick)
            if self._stop.is_set():
                return
            if woke:
                self._wake.clear()
                if self.debounce_s > 0:
                    self._stop.wait(self.debounce_s)  # let a scrape burst land
            now_s = self.clock()
            for sq in self.registry.list():
                try:
                    if (sq.rule_name or sq.alert_sink is not None) and sq.eval_interval_s:
                        if now_s - sq.last_refresh_s >= sq.eval_interval_s:
                            self.refresh(sq)  # rules evaluate on their own clock
                    elif woke and now_s - sq.last_refresh_s >= self.debounce_s:
                        self.refresh(sq)
                except Exception:  # noqa: BLE001
                    log.exception("standing maintenance failed")
            if now_s - last_promo >= 2.0:
                last_promo = now_s
                try:
                    self.promote_tick(now_s)
                    self.demote_tick(now_s)
                except Exception:  # noqa: BLE001
                    log.exception("standing promotion scan failed")

    # -- introspection -----------------------------------------------------------

    def snapshot(self) -> dict:
        """``/debug/standing``: the registry, demotions, subscriber counts and
        the scheduler's recurrence ring."""
        return {**self.registry.snapshot(), "subscribers": self.hub.snapshot(),
                "key_ring": self.scheduler.key_ring.snapshot()}

    def rules_payload(self) -> dict:
        """The Prometheus ``/api/v1/rules`` shape of the registered recording
        rules (one synthetic ``standing`` group)."""
        rl = self.registry.rules()
        if not rl:
            return {"groups": []}
        rules = [{
            "name": sq.rule_name, "query": sq.promql,
            "health": "err" if sq.last_error else "ok", "lastError": sq.last_error or "",
            "evaluationTime": float(sq.last_eval_duration_s),
            "lastEvaluation": rfc3339(int(sq.last_refresh_s * 1000)),
            "type": "recording", "labels": {},
        } for sq in rl]
        return {"groups": [{
            "name": "standing", "file": "", "interval": 0,
            "evaluationTime": sum(float(sq.last_eval_duration_s) for sq in rl),
            "lastEvaluation": rfc3339(int(max(sq.last_refresh_s for sq in rl) * 1000)),
            "rules": rules,
        }]}
