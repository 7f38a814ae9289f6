#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``filodb_tpu_torch``) on one NVIDIA
card: build its kernels, hold each kernel against its plain PyTorch
version, drive every rung of the main path at full size, and check what
comes out.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):

1. Build ``filodb_tpu_torch/csrc/window_stats.cu``, ``regular_range.cu``,
   ``hist_range.cu``, ``general_range.cu``, ``order_stats.cu``,
   ``sorted_window.cu``, ``segment_agg.cu`` and ``jitter_range.cu`` with
   nvcc, and the histogram kernel's split builds (``tile_sweep.HIST_PATCHES``:
   search only and fetch only of the aggregate; compute only and store only
   of the store mode), all at once, and bind their seventeen entry points
   (``filodb_window_stats``,
   ``filodb_window_range_aggregate``, ``filodb_regular_range``,
   ``filodb_hist_range_aggregate``, ``filodb_hist_resident``,
   ``filodb_hist_quantile_gather``, ``filodb_general_range_aggregate``,
   ``filodb_topk_steps``, ``filodb_segment_quantile``,
   ``filodb_segment_topk``, ``filodb_sorted_window``,
   ``filodb_segment_aggregate``, ``filodb_hist_range_series``,
   ``filodb_hist_instant``, ``filodb_jitter_range``,
   ``filodb_hist_range_jitter``, ``filodb_hist_jitter_resident``); print their
   ptxas lines (registers, shared memory, spills) and the card's name and
   power limit.
2. Window stats (the nine-plane kernel), kernel vs plain on seeded
   irregular blocks, S in {1, 65, 4096} and T in {128, 768}, gauge and
   counter data: count exact, first/last timestamps bit-equal, the other
   planes within rtol 2e-4 / atol 1e-4, NaN masks equal; and one block
   with tied timestamps, where the kernel sums the tied first/last values
   as the plain version does.
2b. The fused window-stats kernel (``window_range_aggregate``) vs
   ``window_range_aggregate_plain``: every function of ``PALLAS_FUNCS`` x
   sum/count/avg/min/max over a gauge block (NaN samples) and a counter
   block (raw near zero, so the zero-crossing cap engages), both with
   tied timestamps, a row with no sample, padded trash rows and a grid
   that starts before the first sample and ends past the last (empty
   windows); G in {1, 8} (shared-memory partials), 120 and S (above the
   shared-memory budget: global atomics). NaN masks equal; rtol 2e-4 /
   atol 1e-4 at G = S; elsewhere rtol 1e-3 (atomics reorder a group's f32
   sums) with atol 1e-5 of the largest |value| (sums that cancel).
2c. The general kernel (``csrc/general_range.cu``:
   ``general_range_aggregate``, B4) vs ``general_range_aggregate_plain``:
   every function of ``GENERAL_FUNCS`` x sum/count/avg/min/max over seeded
   irregular blocks staged by the port as gauges, corrected, shifted and
   diff counters (a reset in every fourth row) and delta counters, with
   tied timestamps, a row with no sample, padded trash rows and a grid from
   before the first sample to past the last (empty and one-sample
   windows), and over the same series moved onto one 10 s grid (the
   block's shared bounds table); G in {1, 8} (shared-memory partials), 120
   and S (global atomics); changes/resets bit-equal (integer counts), the
   others within the tolerances of 2b, NaN masks equal.
3. Regular range kernel vs plain on seeded blocks on one shared 10 s grid,
   same S and T: every function of ``FUSED_MXU_FUNCS`` over gauge,
   corrected-counter and diff-counter blocks with each row its own group
   (G = S, bit-equal to the plain version: max_abs_err 0 is printed;
   rtol 2e-4 / atol 1e-4 asserted, NaN masks equal), and each op
   sum/count/avg/min/max at G in {1, 8} (shared-memory partials) and at a
   G past the shared-memory budget (global atomics; rtol 1e-3: atomics
   reorder the f32 sums of a group).
4. Irregular main path: 100k ``http_requests_total`` counter series on 8
   shards, 720 samples each at irregular 5-15 s intervals, ingested through
   ``TimeSeriesShard.ingest_series``; ``sum(rate(...[5m]))`` and
   ``sum by (zone) (rate(...[5m]))`` through ``QueryEngine`` on the card.
   Each query must launch the fused window-stats kernel exactly once and
   neither the nine-plane nor the regular kernel, and its [G, J] result
   must match the same superblock through ``window_range_aggregate_plain``
   (rtol 1e-3: atomics reorder the f32 sums; NaN masks equal). Prints, per
   query, the fused kernel's time (the median of 20 calls after warm-up,
   each between two CUDA events, which counts the launch's host work; and
   per call over 50 back-to-back launches, where that work hides behind
   the previous kernel), the device path's and the bound: the bytes the
   query needs (each real sample's ts, value and raw value, each series'
   length and gid read once, [G, J] written once). Then the nine-plane
   kernel at the same shape, its time beside its bound.
5. Regular main path: bench.py's own store, as its ``build_memstore``
   builds it with jitter 0: the same 100k counters with 720 samples each at exactly 10 s
   from ``BASE``, values ``cumsum(uniform(0, 10)) + 1e9``. Each of the two
   queries must be classed ``regular``, take the ``mxu`` rung, launch the
   regular kernel exactly once and no window-stats kernel, and match both
   the plain path on the card and the window-stats rung on the same
   superblock (rtol 1e-3). Prints staging seconds and, per query, the
   device path's ms, the kernel's ms (median of 20, and back to back) and
   the bound; then
   ``sum(sum_over_time)``'s kernel ms, device path ms (the wrapper:
   accumulators, kernel, [G, J] finish) and bound, the plain path's ms, and
   ``torch.matmul(vals, W)`` (cuBLAS f32, TF32 off: the JAX package's
   window sums). A regular bound counts the 32-byte sectors of vals (and
   raw) the function reads over the real rows, gids and the outputs, from
   the query's window bounds. Then sum(rate)'s warm p50 over
   ``WARM_P50_RUNS`` runs (phase 14's reference), and the regular kernel's
   B5 codes (``time_b5_codes``: changes, resets, min/max_over_time, deriv,
   predict_linear, absent_over_time) in store mode on that superblock,
   each against its plain version and timed back to back alternating with
   the rung the port took before (general or window stats).

   In phases 4 and 5 every query runs twice. The phase's first query is
   the cold build (a cache miss: per-shard staging, concatenation,
   upload); every other run must be a superblock-cache hit with no
   staging, one launch and the cold run's [G, J] (rtol 1e-3, NaN masks
   equal). Cold and warm end-to-end ms print side by side; the staging
   seconds come from a cold build of the first query's superblock against
   a fresh cache with the shards' staging caches cleared (the second query
   selects the same series and reads it from the cache).
6. bench.py's ``ingest_impact`` on phase 5's store: ``sum(rate(...[5m]))``
   to the live edge, one cold query, 10 idle warm queries, then queries
   while a thread ingests one sample per series every 100 ms through
   ``ingest_routed`` (at most 40 batches: 720 + 40 <= 768, the padded
   width): at least 10, and on until a batch has landed (cut from 15
   queries and 4 batches to keep the script's time). Every query
   launches ``regular_range`` once; the cached superblock must extend at
   least once and never restage or abort. After the stream one more batch
   lands; the block held from before that last extension must be
   unchanged and return its earlier result; the final [G, J] must match
   the plain path on a superblock built afresh from the final store, whose
   real ts and lens equal the extended block's bit for bit (vals and raw
   within rtol 1e-6). Prints the idle and busy means and their ratio
   (means, as bench.py argues), the extensions, the bytes each uploads and
   its host (row-set proof, tail reads, the rest) and device ms.
6b. The same on bench.py's jittered store (``build_memstore(jitter=0.05,
   phase_ms=5000)``, seed 42, phase 14's store), appending at the next
   nominal slot +-4 %: the superblock is classed ``jitter`` and every query
   launches the jitter kernel once (5 idle queries; at least 6 busy ones,
   and on until 3 batches have landed); the fresh build's nominal grid and
   deviation bound equal the extended block's, and the final answer equals
   the jitter rung's plain path and the window-stats rung's.

7a. The histogram kernel of ``csrc/hist_range.cu`` vs its plain versions
   on seeded 12-bucket blocks (300 real rows of 512 and 3000 of 4096): the
   partials for every function of ``FUSED_HIST_FUNCS`` x is_delta, shared
   and per-series bounds, G in {1, 8} (shared-memory partials) and the real
   rows (each row its own group: bit-equal); elsewhere rtol 1e-3; the
   quantile folded into the launch at q in {-0.1, 0, 0.5, 0.99, 1, 1.1}
   against ``hist_quantile_plain`` on that launch's partials, with a
   zero-total group, an empty group and a bucket without a member, first
   bounds 0.005, 0 and -1. NaN masks equal.
7b. bench.py's ``hist_quantile`` workload: its ``build_memstore_hist``
   (100k native histograms, PROM_DEFAULT, 720 samples at 10 s, seed 42)
   rebuilt through the port, and
   ``histogram_quantile(0.99, sum by (le) (rate(http_request_latency_bucket[5m])))``
   over bench.py's range, cold then warm: grid ``regular``, variant
   ``hist_shared``, exactly one launch per query (the range kernel, the
   quantile folded in) and no other kernel, the warm query a cache hit
   with no staging; then ``sum by (le)`` of the same selection, one launch
   and no quantile; [G, J] equals the plain path on the card (rtol 1e-3)
   and bench.py's f64 oracle (``cpu_baseline_hist``, rtol 5e-3). On that
   superblock, at the main path's shape and layout, one launch per q in
   {0.25, 0.5, 0.9, 0.99}: its [G, J, B] partials equal their plain
   version's (rtol 1e-3, member counts exact) and its folded quantile the
   plain quantile of those partials (the panel's q = 0.99 lands in the top
   bucket on bench.py's data whatever the sums, so it alone cannot catch a
   wrong sum). Prints cold, warm and device-path ms, the superblock's
   bytes, the kernel's ms alone and with the quantile folded in (median of
   20, and back to back; the fold's own ms is the difference) beside its
   bound, the sector floor (the 32-byte sectors the sampled positions
   touch), the split builds' ms and the plain versions' ms; the same at
   G = 1000 (the large-G tail of the folded quantile). Then the live edge:
   the query to past the newest sample, one batch of one sample per
   series, the query again must extend (not restage) the cached
   superblock; the held block stays unchanged, and a fresh build's ts, lens
   and vals equal the extended block's bit for bit.
7c. The per-series bounds at scale: bench.py's histograms, cut to 25k
   series (``HIST_IRREGULAR_SERIES``; 50k before the jitter rungs' phase
   14, cut to keep the script's time), on irregular 5-15 s scrapes, the
   canonical query cold then warm on ``hist_general``, against the plain
   path and with 7b's partials check, with the kernel's times and bounds.
   (Its superblock is not extended: an irregular histogram superblock
   restages on a live-edge append, as in the JAX package.)
7d. The per-series bounds at 100k series without a host build: 7a's
   generator drawn in bulk on the card (``hist_block_bulk_on_card``), the
   canonical rate into one group with the quantile folded in, against
   plain, timed as in 7b, and at 2, 4 and 8 rows per tile.

8. The general rung at full size (after phase 4, on its store, and after
   phase 6, on phase 5's): through ``QueryEngine``, cold then warm,
   ``sum(irate)`` (a hit on phase 4's corrected superblock), ``sum by
   (zone) (changes)`` and ``sum(resets)`` (a diff build), ``sum(deriv)``
   and ``sum by (zone) (stddev_over_time)`` (a shifted build) over
   ``http_requests_total[5m]``, and ``sum(rate(...[5m] offset 1m))`` (the
   window-stats rung on the shifted range, which must equal phase 4's
   ``sum(rate)`` one step earlier); then ``sum(changes(...[5m]))`` on the
   regular store, which takes the general rung there too. Each run must
   take its rung with exactly one launch of its kernel and no other, the
   warm run must be a hit with no staging, and [G, J] must match the plain
   path (rtol 1e-3, NaN masks equal). Prints, per query and beside the
   card's name and power limit, the cold and warm latency, the kernel's ms
   (median of 20, and back to back), the device path's ms, the plain
   path's ms and the bound: ts and vals per real sample, lens and gids per
   series and [G, J] (bytes), or the in-window samples' operations,
   whichever is longer. (A diff superblock restages under live-edge
   ingest, as in the JAX package: phase 8 does not extend one.)

9. The fused epilogues (B9) at full width, on the superblocks phases 4,
   5 and 8 staged (after phase 8 on phase 4's irregular store, and after
   phase 8's regular query on phase 5's): ``topk(5, rate)``, ``bottomk(5,
   irate)``, ``quantile(0.99, rate)``, ``quantile by (zone) (0.5,
   stddev_over_time)``, ``topk(1000, rate)`` and ``quantile by (instance)
   (0.5, rate)`` (100k groups of one series) over
   ``http_requests_total[5m]`` on the irregular store, ``topk(10, rate)``
   and ``quantile by (zone) (0.9, rate)`` on the regular one. Each runs
   twice through ``QueryEngine`` (the first run's cache outcome printed,
   the second a hit) with exactly two launches: the rung the ladder names
   in its store mode, then one order-statistics kernel
   (``filodb_topk_steps`` or ``filodb_segment_quantile``), and no other
   kernel. The store-mode grid equals the rung's plain per-series grid
   (rtol 1e-3, NaN masks equal); the kernel's [k, J] set equals
   ``topk_steps_plain``'s on the same card grid bit for bit, and its
   [G, J] quantiles ``segment_quantile_plain``'s (selected order
   statistics bit-equal, interpolated ones within 2 ulp); the presented
   rows equal the plain path's end to end (the plain grid, the plain
   epilogue, ``_present_topk``): quantiles within rtol 1e-3 with NaN masks
   equal, topk winner sets equal except at near ties (a series only one
   side chose lies within rtol 1e-3 of the other side's boundary value).
   Prints per query the order-statistics kernel's route and cluster size
   (``order_stats.LAST_PLAN``: topk columns and the large groups staged in
   the shared memory of a cluster of blocks, groups of one a thread each),
   its ms (median of 20, and back to back) beside its bound (one read of
   the real series at the real steps, the outputs written once), the plain
   version's ms and the library call's (``torch.topk`` over the same grid;
   ``torch.nanquantile`` over its real steps for a global quantile; none
   for a grouped one), and the store launch's ms beside the sum
   aggregate's of the same function and the store's bound (the rung's
   reads and the grid written once).
9b. The order-statistics kernels' streaming route, kernel only: a grid of
   111 steps x 1,048,576 series drawn on the card (``order_grid_on_card``:
   rate-like values to three decimals, 2 % NaN; 466 MB), past what a
   cluster's shared memory holds, so both kernels read it from device
   memory in every pass (route ``stream``); ``topk(5)`` and one global
   ``quantile(0.99)`` against their plain versions (winner sets
   bit-equal; quantiles equal, within 2 ulp where interpolated), timed
   beside their bounds and the plain versions.
2d. The reference tree's kernels against their plain versions
   (``phase_tree_kernels_vs_plain``, after 2c): the sorted-window kernel,
   predict_linear and Holt-Winters on the general kernel, and the
   standalone quantile over gathered classic rows.
10. The reference tree at full width (``phase_tree``, after phase 9 on
   phase 4's store and on phase 5's): ``TREE_QUERIES`` unaggregated, each
   first (only the phase's first query with fresh caches: the later cold
   repeats were cut to keep the script's time) then warm (``TREE_ONCE``,
   the bare selector, mad_over_time and an offset rate, each on one store:
   one run, not timed), one launch of
   its rung per shard leaf and no other
   kernel, the warm run a staging-cache hit on the same device copies;
   [S, J] rows against the plain path; cold/warm latency, the host split,
   the kernels' ms beside their bounds and plain ms. On the regular store
   predict_linear takes the regular kernel's B5 code, as the JAX ladder's
   MXU rung.
10b. Classic buckets (``phase_classic``, after 7d): 10,000 label sets x 12
   ``le`` bounds of bench.py's histograms as 120,000 counters;
   ``CLASSIC_QUERIES`` cold then warm, the aggregate and one gather each,
   against the plain fold and bench.py's f64 oracle.
10c. Time slicing (``phase_month``): 1,000 counters at 5 min over 30 days;
   ``MONTH_QUERIES`` planned as two stitched slices, against the plain
   path on the card.
2e. The tree's aggregate kernels against their plain versions
   (``phase_tree_aggregates_vs_plain``, after 2d): the segment aggregate
   (``csrc/segment_agg.cu``, K1) and the grouped top-k
   (``filodb_segment_topk`` in ``csrc/order_stats.cu``, K2) on seeded
   100,000 x 111 blocks read in place: G = 1, 8, 100,000 groups of one and
   3,000 groups (past K1's shared-memory budget), 2 % NaN, ties, +-inf and
   signed zeros; K2 also over a shard leaf's 12,500 series (the step
   route), at k in {1, 3, 16, 32, 33, 1000}; K1's count/min/max/group and K2's
   kept values and thresholds bit-equal (K2's max_abs_err measured), K1's
   sum/sumsq within rtol 1e-4.
11. The tree's aggregates, operators and instant functions at full width
   (``phase_tree_aggregates``, after phase 10 on phase 4's store and on
   phase 5's): ``TREE_AGG_QUERIES`` (all on the irregular store but
   count_values; stddev, topk by zone and count_values on the regular
   one) and ``UNFUSED_QUERY`` (with ``fused_aggregate=False``, held against
   the fused answer, irregular store), each first (only the phase's first
   query on fresh caches) then warm, each launch count checked against the plan
   (``expected_launches``: one rung launch per leaf and fused aggregate,
   K1 per map phase, K2 per candidate filter and topk root, one quantile
   per quantile root, no other kernel), the rows against the plain path on
   the card (``plain_kernels``); then K1 and K2 timed at those shapes
   beside their bounds, plain versions and library lines, K2 also on the
   device alone (``torch.profiler``) and on its two routes alternating
   (per-group, step, step, per-group; ``tree_agg_kernels``).

2f. The tree-over-histograms kernels against their plain versions
   (``phase_hist_tree_vs_plain``, after 2e): K1, the histogram range
   kernel's store mode (``hist_range_series``), for every function of
   ``FUSED_HIST_FUNCS`` x is_delta on 7a's seeded blocks with shared and
   per-series bounds, bit-equal to ``hist_series_plain``; K2
   (``hist_instant``: histogram_quantile, its ``even`` variant and
   histogram_fraction) on 4096 x 111 x 12 card-drawn bucket values with
   edge rows, first bounds 0.005, 0 and -1, row-major, the store's
   permuted view and a 6-bucket grid in one launch, within 2 ulp of the
   plain versions.
12. The reference tree over native histograms (``phase_hist_tree``, after
   7b on its store and after 7c on its irregular one): ``HIST_TREE_QUERIES``
   (7c: the first two) and ``HIST_UNFUSED_QUERY`` with
   ``fused_aggregate=False``, each first (only the first query restages)
   then warm (histogram_fraction and histogram_bucket: one run, warm), the launches checked against the plan
   (``expected_hist_launches``: K1 per shard leaf, K2 per histogram
   function node, a segment aggregate per leaf's map phase, no other
   kernel); the warm answer against the plain path on the card (K1's
   buckets bit-equal, K2's values within 2 ulp), the unfused quantile
   against the fused one (rtol 1e-3); cold and warm ms with the warm split
   (execute, rows to the host: the D2H of a 100k-row ``[S, J, B]``
   answer); K1 and K2 timed over the leaves beside their bounds and plain
   versions, K1 also on the device alone and in its split builds (compute
   only, store only; ``time_hist_tree_kernels``).

2g. The regular kernel's B5 codes and both variants of the jitter kernel
   (``csrc/jitter_range.cu``: JITTER over a jittered block, MASKED over a
   holey block's sidecar) against their plain versions
   (``phase_jitter_vs_plain``, after 2f): seeded blocks of 1 (a near-regular
   grid needs 2), 65 and 4096 series padded to T 128 and 768, staged as
   gauges and corrected, diff and shifted counters; each function of its
   staging mode in store mode and as the aggregate at G = S and G = 8;
   counts exact, NaN masks equal, values within rtol 2e-4 / atol 1e-4 (G =
   8: rtol 1e-3); the decline (a window of twice the deviation bound takes
   window stats, one ms more the jitter rungs, whose narrow windows are
   held to plain too); max_abs_err per code.
14. bench.py's ``fused_jitter`` stores through the port at full width
   (``phase_fused_jitter``, after 9b): 50k counters (``FUSED_JITTER_SERIES``:
   bench.py's 100k cut to half, to keep the script's time; 6b
   runs on the jittered one) on 8 shards, 720
   samples at 10 s, jitter 0.05, phase 5 s, seed 42, ``hole_frac`` 0
   (grid ``jitter``) and 0.01 (``holes``). ``FUSED_JITTER_QUERIES`` first
   then warm: the fused aggregates one launch of the jitter kernel
   (``jitter`` or ``masked``), ``topk(5, rate)`` its store mode and one
   order-statistics launch, the tree's ``rate`` leaves on the jitter rungs
   and ``changes``/``deriv`` on the general one (the JAX ladder's); the
   tree's rows and the epilogue's grid against the plain path on the card
   (rtol 1e-3); each fused aggregate's kernel in store mode and in its
   aggregate mode at G = S (every series its own group) against plain per
   series (rtol 2e-4 / atol 1e-4) and its [G, J] against plain's values
   summed in f64 and against the window-stats or general rung on the same
   superblock (rtol 5e-3: f32 atomic sums of 100k values up to 1e9;
   sum(count_over_time) exactly), that rung's kernel timed back to back
   alternating with the jitter kernel; sum(rate) against bench.py's f64 oracle (rtol 5e-3); the warm
   p50 of sum(rate) against phase 5's (bench.py's ratio, here at half
   phase 5's series); the holey store's first query (its cold staging and
   the masked sidecar, built at the masked rung's first read) with the
   sidecar's own build time.
15. The server (``phase_http``, after phase 13 on phase 5's store):
   ``api/http.serve_background`` over that engine on the card, on
   127.0.0.1. ``HTTP_RANGE_QUERIES`` (the north star, by zone, topk(5,
   rate), an unaggregated rate over the 1,000 series of an ``instance``
   regex: the tree), the north star's instant form, labels, the values of
   ``zone`` and a series request limited to 10, each held against
   ``QueryEngine`` called directly on the card (labels and timestamps
   exact, values rtol 1e-5: group atomics may move an ulp); each
   query's warm p50 over ``HTTP_RUNS`` runs through HTTP beside the
   engine's, with the server's split from its ``Server-Timing`` header
   (plan, execute -- the launch and the rest of the plan's run --,
   transfer from the device, render) and the socket's share (the
   client's wall less the server's). Then a remote write of 1,000 new
   series x 10 samples at the live edge (the port's prompb codec),
   ``/api/v1/read`` of them (equal to what was written), a ``count()``
   that sees them, an ``/ingest/prom`` body, ``/metrics``, and
   ``/debug/superblocks`` and ``/debug/resources``: the ledger's drift 0
   on every kind, its ``superblock`` bytes equal to the cache's own walk,
   their device ``cuda:0``.
15b. The CLI (``phase_cli``): ``python -m filodb_tpu_torch.cli serve``
   in a subprocess with no device flag (it must take the card), ``cli
   ingest-csv`` of 50 series x 60 rows and ``cli query-range`` of a ``sum
   by (zone) (rate(...))`` held against a CPU engine on the same rows;
   ``/debug/resources`` must show the server's engine and superblock on
   the card. The subprocess is ended in every case.
16. The histogram jitter mode (B1; ``phase_hist_jitter``, after phase 12's
   regular store): bench.py's 100k x 12-bucket ``hist_quantile`` draws
   (7b's, drawn once: ``build_memstore_hists`` ingests each block into
   both stores) on bench.py's ``fused_jitter`` timestamps (+-5 % of 10 s
   around a 5 s phase). The SRE panel through a server on the store's
   engine, cold then warm, and through the engine directly (warm p50 over
   ``HTTP_RUNS``), each exactly one ``hist_range`` launch in the jitter
   mode with the quantile folded in; ``sum by (le)`` one launch, no fold;
   [G, J] against the plain path (rtol 1e-3) and an f64 oracle over each
   series' own timestamps (``cpu_baseline_hist_series``, rtol 5e-3); the
   aggregate mode at G = S per series against plain (rtol 2e-4 / atol
   1e-4); the kernel per call and back to back, alternating with
   ``hist_general`` on the same superblock, beside its bound in bytes.

Around every timed phase it prints the card's SM and memory clocks,
temperature and power draw (nvidia-smi), before and after. Prints, in
order at the end: one JSON object with phases 6 and 6b's numbers
(``{"cache": ...}``), one with phases 7b-7d's (``{"hist": ...}``), one
with phase 9's (``{"epilogues": ...}``), one with phases 2d, 2e, 10-10c
and 11's (``{"tree": ...}``), one with phases 2f and 12's
(``{"hist_tree": ...}``), one with phases 2g and 14's (``{"jitter":
...}``), one with phases 15 and 15b's (``{"server": ...}``; phase 16's
is in ``{"hist": ...}``), one with the kernels' numbers
(the order-statistics kernels' rows, and the store mode's numbers on the
rungs' rows), the card's
name and power limit as nvidia-smi gives them, and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
where no CUDA device is available.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASE = 1_600_000_000_000
N_SHARDS = 8
SPREAD = 3
STEP_S = 60.0
WINDOW_MS = 300_000
N_SERIES = 100_000
# phase 14's stores (and phase 6b on the jittered one): bench.py's
# fused_jitter stores cut to half its series to keep the script's time
FUSED_JITTER_SERIES = 50_000
N_SAMPLES = 720
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
QUERIES = (
    "sum(rate(http_requests_total[5m]))",
    "sum by (zone) (rate(http_requests_total[5m]))",
)
SOURCES = ("window_stats", "regular_range", "hist_range", "general_range",
           "order_stats", "sorted_window", "segment_agg", "jitter_range")  # csrc/<name>.cu
START_S = (BASE + 400_000) / 1000  # bench.py's range
END_S = (BASE + N_SAMPLES * 10_000 - 200_000) / 1000
# bench.py's ingest_impact: the range reaches past the newest sample (the
# live edge), and a stream appends one sample per series per batch
MAX_APPEND_BATCHES = 600
LIVE_END_S = (BASE + (N_SAMPLES + MAX_APPEND_BATCHES + 20) * 10_000) / 1000
LIVE_QUERY = QUERIES[0]
MAX_BATCHES = 40  # N_SAMPLES + 40 <= 768, the superblock's padded width
JITTER_PHASE_MS = 5_000  # no jittered slot within 5 % of the 5 m staging boundary


T0 = time.perf_counter()


def elapsed(tag: str) -> None:
    """The script's seconds so far, after a phase."""
    print(f"elapsed {time.perf_counter() - T0:.1f} s after {tag}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def back_to_back_ms(fn, reps: int = 50) -> float:
    """Device time per call of ``fn`` launched ``reps`` times back to back
    between two CUDA events: each call's host work overlaps the previous
    call's kernel, so for a kernel longer than its launch this is the
    kernel's own time (``cuda_ms`` also counts the launch's host work)."""
    import torch

    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, match: str, reps: int = 20) -> float:
    """Device ms per call of ``fn`` in the kernels whose name holds
    ``match``, from ``torch.profiler``'s CUDA activity over ``reps`` calls
    after warm-up: the kernels alone, where back-to-back launches shorter
    than their host enqueue would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages() if match in e.key)
    return total / reps / 1e3


def graph_ms(fn, reps: int = 50) -> float:
    """Device ms per call of ``fn`` captured ``reps`` times into one CUDA
    graph and replayed between two CUDA events (median of 5 replays): a
    launch shorter than its host enqueue, which back to back would time,
    without the host in the way; the graph's gap between two kernels is in
    it. ``torch.profiler`` reads such a kernel too, but in this script's
    long process it missed the short launches of phase 10b."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def host_ms(fn, reps: int = 200) -> float:
    """Host ms per call of ``fn``: what it takes to enqueue a launch (the
    wrapper's Python, ctypes and the CUDA runtime), the device drained
    before and after."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def compare(got, want, what: str, rtol: float, atol: float = 0.0) -> float:
    """NaN masks equal and values within rtol/atol; returns the largest
    absolute difference."""
    import torch

    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(torch.equal(torch.isnan(got), torch.isnan(want)), f"{what}: NaN masks differ")
    m = ~torch.isnan(want)
    gm, wm = got[m], want[m]
    bad = (gm - wm).abs() > atol + rtol * wm.abs()
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} values outside tolerance")
    return float((gm.double() - wm.double()).abs().max()) if gm.numel() else 0.0


def compare_stats(got: dict, want: dict, rtol: float = 2e-4, atol: float = 1e-4) -> float:
    """Hold the kernel's nine planes against the plain version's; returns
    the largest absolute difference over the planes."""
    import torch

    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if name in ("count", "t_first", "t_last"):
            m = ~torch.isnan(w)
            require(torch.equal(g[m], w[m]), f"{name}: kernel differs from plain")
        worst = max(worst, compare(g, w, name, rtol, atol))
    return worst


def build_kernels() -> dict:
    """Build every source and the histogram kernel's split builds at
    once (one nvcc each), bind the seventeen entry points, print ptxas's lines
    (registers, shared memory, spills) and return the split builds."""
    from filodb_tpu_torch.ops import cuda_build
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops import mxu_jitter as JR
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import order_stats as OS
    from filodb_tpu_torch.ops import window_stats as WS

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        split = pool.submit(hist_split_libs)
        libs = list(pool.map(cuda_build.build, SOURCES))
        split_libs = split.result()
    from filodb_tpu_torch.ops import segment_agg as SA
    from filodb_tpu_torch.ops import sorted_window as SW

    ws_lib, mk_lib, hk_lib, gr_lib, os_lib, sw_lib, sa_lib, jr_lib = (
        WS._load(), MK._load(), HK._load(), GR._load(), OS._load(), SW._load(), SA._load(),
        JR._load())
    entries = [ws_lib.filodb_window_stats, ws_lib.filodb_window_range_aggregate,
               mk_lib.filodb_regular_range, hk_lib.filodb_hist_range_aggregate,
               hk_lib.filodb_hist_resident, hk_lib.filodb_hist_quantile_gather,
               gr_lib.filodb_general_range_aggregate, os_lib.filodb_topk_steps,
               os_lib.filodb_segment_quantile, os_lib.filodb_segment_topk,
               sw_lib.filodb_sorted_window, sa_lib.filodb_segment_aggregate,
               hk_lib.filodb_hist_range_series, hk_lib.filodb_hist_instant,
               jr_lib.filodb_jitter_range, hk_lib.filodb_hist_range_jitter,
               hk_lib.filodb_hist_jitter_resident]
    print(f"phase1 built {', '.join(l.name for l in libs)} in {time.perf_counter() - t0:.1f} s; "
          f"entry points {', '.join(e.__name__ for e in entries)}")
    for name in SOURCES:
        entry = ""
        for line in cuda_build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"phase1 ptxas {name} {entry}: {line.strip()}")
    print(f"phase1 split builds of hist_range: {', '.join(split_libs)}")
    return split_libs


def gpu_sample(tag: str) -> None:
    """Print the card's clocks, temperature and power draw beside a timed
    phase (kernel times moved 10-25 % between calls on unchanged code)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    print(f"clocks {tag}: sm, mem, temperature, power = {out.stdout.strip().splitlines()[0]}")


def random_block(S: int, T: int, counter: bool, rng, device):
    """Seeded irregular rows: strictly increasing timestamps 5-15 s apart,
    ragged lengths, TS_PAD past each row's length."""
    import torch

    from filodb_tpu_torch.ops.staging import TS_PAD

    lens = rng.integers(T // 2, T + 1, S).astype(np.int32)
    ts = np.full((S, T), TS_PAD, np.int32)
    steps = rng.integers(5_000, 15_001, (S, T))
    start = rng.integers(0, 20_000, (S, 1))
    real = (start + np.cumsum(steps, axis=1)).astype(np.int32)
    mask = np.arange(T)[None, :] < lens[:, None]
    ts[mask] = real[mask]
    if counter:
        vals = np.cumsum(rng.uniform(0, 10, (S, T)), axis=1).astype(np.float32)
        raw = (vals + 1e3).astype(np.float32)
    else:
        vals = (50 + 20 * rng.standard_normal((S, T))).astype(np.float32)
        raw = vals
    vals = np.where(mask, vals, 0).astype(np.float32)
    raw = np.where(mask, raw, 0).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (ts, vals, raw, lens)]


WINDOW_KINDS = {  # kind -> (sample spacing in ms, low, high)
    "irregular": (5_000, 15_001), "regular": (10_000, 10_001), "long": (5_000, 5_001)}


def window_block(n_real: int, T: int, kind: str, counter: bool, seed: int, device):
    """Seeded rows for the sorted-window and argument kernels (phase 2d,
    the card and CPU tests), as a block on ``device``: ``irregular``
    timestamps 5-15 s apart with a tied pair in every 7th row, one
    ``regular`` 10 s grid shared by every real row, or ``long`` rows 5 s
    apart (a 1 h window holds 720 samples); gauge values on a 0.5 lattice
    (ties) with -0.0 and 0.0 among them, or shifted-counter values
    (cumulative, from 0); NaN samples in every 5th row; on the irregular
    grid row 1 has no sample and the lengths are ragged; rows past
    ``n_real`` padded as staging pads them."""
    from filodb_tpu_torch.ops.staging import TS_PAD, block_from_arrays, pad_series

    rng = np.random.default_rng(seed)
    S = pad_series(n_real)
    lo, hi = WINDOW_KINDS[kind]
    m = T - (T // 16 if kind != "long" else 48)
    if kind == "regular":
        lens = np.full(n_real, m, np.int32)
        real = np.broadcast_to(3_000 + np.arange(T) * 10_000, (n_real, T)).astype(np.int64)
    else:
        lens = rng.integers(m // 2, m + 1, n_real).astype(np.int32)
        real = rng.integers(0, 20_000, (n_real, 1)) + np.cumsum(rng.integers(lo, hi, (n_real, T)),
                                                               axis=1)
        if kind == "irregular":
            lens[min(1, n_real - 1)] = 0 if n_real > 1 else lens[0]
            real[::7, 5] = real[::7, 4]  # a tied pair
    if counter:
        vals = np.cumsum(rng.uniform(0, 10, (n_real, T)), axis=1)
        vals -= vals[:, :1]
    else:
        vals = np.round(2 * (50 + 20 * rng.standard_normal((n_real, T)))) / 2
        vals[rng.random((n_real, T)) < 0.03] = -0.0
        vals[rng.random((n_real, T)) < 0.03] = 0.0
    nan_rows = np.arange(0, n_real, 5)
    vals[nan_rows[:, None], rng.integers(0, m // 2, (len(nan_rows), 3))] = np.nan
    live = np.arange(T)[None, :] < lens[:, None]
    ts = np.full((S, T), TS_PAD, np.int32)
    ts[:n_real] = np.where(live, real, TS_PAD).astype(np.int32)
    v = np.zeros((S, T), np.float32)
    v[:n_real] = np.where(live, vals, 0.0)
    L = np.zeros(S, np.int32)
    L[:n_real] = lens
    return block_from_arrays(ts, v, L, BASE, np.zeros(S, np.float32), n_real, device=device)


def abs_gap(got, want) -> float:
    """The largest absolute difference between two f32 tensors' finite
    values (``ulp_gap`` has held their NaN and infinity masks equal)."""
    import torch

    m = torch.isfinite(want)
    return float((got[m].double() - want[m].double()).abs().max()) if bool(m.any()) else 0.0


def ulp_gap(got, want) -> int:
    """The largest distance in units in the last place between two f32
    tensors' finite values (their infinities and NaN masks must agree)."""
    import torch

    require(torch.equal(torch.isnan(got), torch.isnan(want)), "NaN masks differ")
    inf = torch.isinf(want)
    require(torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf]),
            "infinities differ")
    m = torch.isfinite(want)
    if not bool(m.any()):
        return 0

    def ordered(x):
        i = x[m].contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)

    return int((ordered(got) - ordered(want)).abs().max())


def phase_window_stats_vs_plain(seed: int, device) -> None:
    import torch

    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.staging import TS_PAD

    rng = np.random.default_rng(seed)
    for S in (1, 65, 4096):
        for T in (128, 768):
            for counter in (False, True):
                ts, vals, raw, lens = random_block(S, T, counter, rng, device)
                J = T * 10_000 // 60_000 - 2
                args = (ts, vals, raw, lens, 100_000, 60_000, WINDOW_MS, J)
                got = WS.window_stats(*args)
                want = WS.window_stats_plain(*args)
                err = compare_stats(got, want)
                k_ms = cuda_ms(lambda: WS.window_stats(*args), reps=10)
                p_ms = cuda_ms(lambda: WS.window_stats_plain(*args), reps=3, warmup=1)
                kind = "counter" if counter else "gauge"
                print(f"phase2 S={S} T={T} J={J} {kind}: match, max_abs_err={err:.3g} "
                      f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f}")
    # tied timestamps: first/last values sum over the tie, as on the TPU
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[0, :4] = [1000, 1000, 2000, 2000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :4] = [1.0, 10.0, 3.0, 4.0]
    raw = np.zeros((8, 128), np.float32)
    raw[0, :4] = [100.0, 200.0, 300.0, 400.0]
    lens = np.zeros(8, np.int32)
    lens[0] = 4
    args = [torch.from_numpy(a).to(device) for a in (ts, vals, raw, lens)] + [2000, 1000, 5000, 64]
    got = WS.window_stats(*args)
    compare_stats(got, WS.window_stats_plain(*args), rtol=0.0, atol=0.0)
    first = (float(got["v_first"][0, 0]), float(got["raw_first"][0, 0]), float(got["v_last"][0, 0]))
    require(first == (11.0, 300.0, 7.0), f"tied timestamps: v_first/raw_first/v_last {first}")
    print(f"phase2 tied timestamps: kernel equals plain, v_first/raw_first/v_last = {first}")


def fused_block(n_real: int, S: int, T: int, counter: bool, rng, device):
    """Seeded irregular rows for the fused phase, through the port's
    ``block_from_arrays``: ragged lengths, a row with no sample, tied
    timestamps in every fifth row, NaN samples in gauges, raw values near
    zero at the start of counter rows (the zero-crossing cap), and rows
    past ``n_real`` padded (the trash group)."""
    from filodb_tpu_torch.ops.staging import TS_PAD, block_from_arrays

    lens = np.zeros(S, np.int32)
    lens[:n_real] = rng.integers(T // 2, T + 1, n_real)
    lens[n_real // 2] = 0
    gaps = rng.integers(5_000, 15_001, (S, T))
    gaps[::5, 7::31] = 0  # ties: a sample at its predecessor's timestamp
    real = rng.integers(0, 20_000, (S, 1)) + np.cumsum(gaps, axis=1)
    mask = np.arange(T)[None, :] < lens[:, None]
    ts = np.where(mask, real, int(TS_PAD)).astype(np.int32)
    raw = None
    if counter:
        vals = np.cumsum(rng.uniform(0, 10, (S, T)), axis=1)
        raw = np.where(mask, vals + rng.uniform(0, 5, (S, 1)), 0).astype(np.float32)
    else:
        vals = 50 + 20 * rng.standard_normal((S, T))
        vals[::3, 11::17] = np.nan
    vals = np.where(mask, vals, 0).astype(np.float32)
    return block_from_arrays(ts, vals, lens, BASE, np.zeros(S, np.float32), n_real, raw=raw,
                             device=device)


def phase_fused_vs_plain(seed: int, device) -> float:
    """The fused window-stats kernel against its plain version; returns the
    largest absolute difference."""
    import torch

    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import RangeParams

    rng = np.random.default_rng(seed + 2)
    n_real, S, T = 300, 512, 384
    # from 200 s before the first sample to past the last one: empty windows
    params = RangeParams(BASE - 200_000, 60_000, 80, WINDOW_MS)
    worst = 0.0
    for counter in (False, True):
        block = fused_block(n_real, S, T, counter, rng, device)
        for G in (1, 8, 120, n_real):
            gids = torch.full((S,), G, dtype=torch.int64, device=device)
            own = G == n_real
            gids[:n_real] = (torch.arange(n_real, device=device) if own else
                             torch.from_numpy(rng.integers(0, G, n_real)).to(device))
            variants = set()
            for func in sorted(WS.PALLAS_FUNCS):
                for op in ("sum", "count", "avg", "min", "max"):
                    got = WS.window_range_aggregate(func, op, block, gids, G, params,
                                                    is_counter=counter)
                    variants.add(WS.LAST_PLAN.partials)
                    want = WS.window_range_aggregate_plain(func, op, block, gids, G, params,
                                                           is_counter=counter)
                    what = f"{op}({func}) G={G} {'counter' if counter else 'gauge'}"
                    if own:
                        err = compare(got, want, what, rtol=2e-4, atol=1e-4)
                    else:
                        scale = float(torch.nan_to_num(want, nan=0.0).abs().max())
                        err = compare(got, want, what, rtol=1e-3, atol=1e-5 * scale)
                    worst = max(worst, err)
            want_variant = "shared" if G <= 8 else "global"
            require(variants == {want_variant}, f"G={G}: group partials {variants}")
            print(f"phase2b {'counter' if counter else 'gauge'} block [{S}, {T}] ({n_real} real "
                  f"rows) G={G}: {len(WS.PALLAS_FUNCS)} functions x 5 ops match plain "
                  f"({want_variant} partials, rows per tile {WS.LAST_PLAN.rows})")
    print(f"phase2b fused kernel matches plain, max_abs_err={worst:.3g}")
    return worst


def regular_block(S: int, T: int, kind: str, rng, device):
    """``S`` seeded series on one shared 10 s grid, staged by the port so
    the block pads to width ``T``: gauges, or counters staged corrected or
    diff-encoded."""
    from filodb_tpu_torch.ops.staging import stage_series

    n = T - 5
    ts = BASE + 3_000 + np.arange(n, dtype=np.int64) * 10_000
    if kind == "gauge":
        vals = 50 + 20 * rng.standard_normal((S, n))
    else:
        vals = np.cumsum(rng.uniform(0, 10, (S, n)), axis=1) + 1e3
    block = stage_series([(ts, v) for v in vals], BASE,
                         counter_corrected=kind == "corrected", diff_encode=kind == "diff")
    require(block.regular_ts is not None and block.shape[1] == T, "regular block expected")
    return block.to_device(device)


def regular_plain(func, op, block, gids, G, params, is_counter):
    """The regular rung's plain version: mxu_range_plain -> segment aggregate
    (NaN past the query's steps, which the kernel does not compute)."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import pad_steps

    wm = MK.window_matrices(block, params.start_ms - block.base_ms, params.step_ms,
                            pad_steps(params.num_steps), params.window_ms)
    raw = block.raw if block.raw is not None else block.vals
    sj = MK.mxu_range_plain(func, block.vals, raw, wm, params.window_ms, is_counter=is_counter)
    return GA.mask_steps(AGG.apply_epilogue(sj, ("agg", op), gids, G), params.num_steps)


def phase_regular_vs_plain(seed: int, device) -> None:
    import torch

    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import RangeParams

    rng = np.random.default_rng(seed + 1)
    group_func = {"gauge": "avg_over_time", "corrected": "rate", "diff": "idelta"}
    for S in (1, 65, 4096):
        for T in (128, 768):
            for kind in ("gauge", "corrected", "diff"):
                block = regular_block(S, T, kind, rng, device)
                counter = kind != "gauge"
                n_steps = ((T - 5) * 10_000 - 600_000) // 60_000 + 1
                params = RangeParams(BASE + 400_000, 60_000, n_steps, WINDOW_MS)
                s_pad = block.vals.shape[0]
                own = torch.full((s_pad,), S, dtype=torch.int64, device=device)
                own[:S] = torch.arange(S, device=device)
                err = 0.0
                for func in sorted(MK.FUSED_MXU_FUNCS):
                    got = MK.regular_range_aggregate(func, "sum", block, own, S, params,
                                                     is_counter=counter)
                    want = regular_plain(func, "sum", block, own, S, params, counter)
                    err = max(err, compare(got, want, f"{func} S={S} T={T} {kind}",
                                           rtol=2e-4, atol=1e-4))
                func = group_func[kind]
                g_big = GA.PARTIALS_BUDGET // (2 * params.num_steps * 4) + 1
                for G in (1, 8, g_big):
                    gids = torch.full((s_pad,), G, dtype=torch.int64, device=device)
                    gids[:S] = torch.arange(S, device=device) % G
                    for op in ("sum", "count", "avg", "min", "max"):
                        got = MK.regular_range_aggregate(func, op, block, gids, G, params,
                                                         is_counter=counter)
                        require(MK.LAST_PLAN.partials == ("global" if G == g_big else "shared"),
                                f"G={G}: {MK.LAST_PLAN.partials} partials")
                        want = regular_plain(func, op, block, gids, G, params, counter)
                        compare(got, want, f"{op}({func}) G={G} S={S} T={T}", rtol=1e-3)
                gids1 = torch.where(own < S, 0, 1)
                k_ms = cuda_ms(lambda: MK.regular_range_aggregate(
                    func, "sum", block, gids1, 1, params, is_counter=counter), reps=10)
                print(f"phase3 S={S} T={T} J={params.num_steps} {kind}: "
                      f"{len(MK.FUSED_MXU_FUNCS)} functions match plain at G=S "
                      f"(max_abs_err={err:.3g}); sum/count/avg/min/max of {func} match at "
                      f"G=1, 8 (shared partials) and {g_big} (global); sum({func}) "
                      f"kernel_ms={k_ms:.4f}")


def series_tags(i: int) -> dict:
    """bench.py's tags of series ``i`` (its ``build_memstore``)."""
    from filodb_tpu_torch.core.schemas import METRIC_TAG

    return {METRIC_TAG: "http_requests_total", "_ws_": "demo", "_ns_": "App-2",
            "instance": f"host-{i}", "zone": f"z{i % 8}"}


def build_memstore(n_series: int, n_samples: int, seed: int, grid: str,
                   hole_frac: float = 0.0):
    """``n_series`` counters on 8 shards, ingested through the port's shard
    API, values cumsum(uniform(0, 10)) + 1e9, drawn per block of 10k series
    as bench.py draws them. ``grid``: ``regular`` is bench.py's store
    (every series at exactly 10 s from BASE); ``jitter`` is bench.py's
    ``build_memstore(jitter=0.05, phase_ms=JITTER_PHASE_MS)`` (the 10 s grid
    shifted by 5 s, each sample moved by a rounded uniform +-5 % of the
    interval), and with ``hole_frac`` its missed scrapes (that share of each
    series' interior slots dropped, drawn per series as bench.py draws
    them; seed 42 is bench.py's store); ``irregular`` has strictly
    increasing 5-15 s intervals."""
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    rng = np.random.default_rng(seed)
    ms = TimeSeriesMemStore(StoreConfig(max_chunk_size=n_samples))
    ms.setup(Dataset("prometheus"), range(N_SHARDS))
    phase = JITTER_PHASE_MS if grid == "jitter" else 0
    nominal = BASE + phase + np.arange(n_samples, dtype=np.int64) * 10_000
    blk = 10_000
    for b0 in range(0, n_series, blk):
        n = min(blk, n_series - b0)
        if grid == "irregular":
            ts = BASE + np.cumsum(rng.integers(5_000, 15_001, (n, n_samples)), axis=1)
        vals = np.cumsum(rng.uniform(0, 10, (n, n_samples)), axis=1) + 1e9
        if grid == "regular":
            ts = np.broadcast_to(nominal, (n, n_samples))
        elif grid == "jitter":
            dev = np.rint(rng.uniform(-0.05, 0.05, (n, n_samples)) * 10_000).astype(np.int64)
            ts = nominal + dev
        for i in range(n):
            tags = series_tags(b0 + i)
            shard = ms.shard("prometheus", shard_for(tags, spread=SPREAD, num_shards=N_SHARDS))
            row_ts, row_vals = ts[i].astype(np.int64), vals[i]
            if hole_frac > 0:
                keep = np.ones(n_samples, bool)
                keep[rng.choice(np.arange(1, n_samples - 1),
                                max(1, int(hole_frac * n_samples)), replace=False)] = False
                row_ts, row_vals = row_ts[keep], row_vals[keep]
            shard.ingest_series(SeriesBatch(
                schema=PROM_COUNTER, tags=tags, timestamps=row_ts, values={"count": row_vals},
            ))
    return ms


def path_args(entry, ex):
    """``(gids, G, params)`` of the exec node's device work."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops.kernels import RangeParams

    gids, G, _ = AGG.group_ids_memo(entry.block, entry.labels, ex.by, ex.without,
                                    strip_metric=True)
    return gids, G, RangeParams(ex.start_ms - ex.offset_ms, ex.step_ms, ex.num_steps(),
                                ex.window_ms)


def device_path(entry, ex):
    """The exec node's device work on a staged superblock."""
    from filodb_tpu_torch.ops import aggregations as AGG

    gids, G, params = path_args(entry, ex)
    return AGG.fused_range_aggregate(ex.function, ex.op, entry.block, gids, G, params,
                                     is_counter=entry.is_counter, is_delta=entry.is_delta)


def window_range_path(entry, ex, plain: bool):
    """The window-stats rung on the exec node's superblock: the fused
    kernel, or its plain version, sliced to the query's steps."""
    from filodb_tpu_torch.ops import window_stats as WS

    gids, G, params = path_args(entry, ex)
    fn = WS.window_range_aggregate_plain if plain else WS.window_range_aggregate
    out = fn(ex.function, ex.op, entry.block, gids, G, params, is_counter=entry.is_counter,
             is_delta=entry.is_delta)
    return out[:, : ex.num_steps()]


KERNEL_COUNTERS = {"window_stats": ("window_stats", "LAUNCHES"),
                   "window_range": ("window_stats", "RANGE_LAUNCHES"),
                   "general_range": ("general_range", "LAUNCHES"),
                   "regular_range": ("mxu_kernels", "LAUNCHES"),
                   "hist_range": ("hist_kernels", "RANGE_LAUNCHES"),
                   "order_stats": ("order_stats", "LAUNCHES"),
                   "sorted_window": ("sorted_window", "LAUNCHES"),
                   "hist_quantile_gather": ("hist_kernels", "QUANTILE_LAUNCHES"),
                   "jitter_range": ("mxu_jitter", "JITTER_LAUNCHES"),
                   "masked_range": ("mxu_jitter", "MASKED_LAUNCHES")}
RUNGS = {"mxu": "regular_range", "window_stats": "window_range", "general": "general_range",
         "jitter": "jitter_range", "masked": "masked_range"}


def run_main(engine, q: str, want_class: str, rung: str, end_s: float = END_S,
             epilogue: bool = False):
    """One query through the user's entry point, with every launch count
    set to 0 just before and read just after; it must take ``rung`` on a
    ``want_class`` grid and launch that rung's kernel once and no other
    (an ``epilogue`` query: the rung's kernel in its store mode and one
    order-statistics kernel). Returns the result, its rows on the host and
    the end-to-end seconds."""
    import importlib

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops.staging import grid_class

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in KERNEL_COUNTERS.items()}
    seen = []
    ladder = AGG.grid_variant

    def watched(block, func, is_delta=False, window_ms=None):
        variant = ladder(block, func, is_delta, window_ms)
        seen.append((grid_class(block), variant))
        return variant

    AGG.grid_variant = watched
    try:
        for name, (_, attr) in KERNEL_COUNTERS.items():
            setattr(mods[name], attr, 0)
        t0 = time.perf_counter()
        res = engine.query_range(q, START_S, end_s, STEP_S)
        vals = res.grids[0].values_np()
        wall = time.perf_counter() - t0
        counts = {name: getattr(mods[name], attr) for name, (_, attr) in KERNEL_COUNTERS.items()}
    finally:
        AGG.grid_variant = ladder
    kernel = RUNGS[rung]
    require(seen == [(want_class, rung)],
            f"{q}: grid class and rung {seen}, expected {[(want_class, rung)]}")
    want = {k: int(k == kernel or (epilogue and k == "order_stats")) for k in KERNEL_COUNTERS}
    require(counts == want, f"{q}: launches {counts}, expected {want}")
    return res, vals, wall


def run_queries(engine, phase: str, rung: str) -> dict:
    """The main path: each query twice through the user's entry point. The
    phase's first query is the cold build (a cache miss: per-shard staging
    and the superblock's upload); every other run must be served from the
    superblock cache with no staging, launch once, and equal the cold
    run's [G, J] (rtol 1e-3: atomics reorder the f32 sums)."""
    import torch

    want_class = "regular" if rung == "mxu" else "irregular"
    results, launches, timings = {}, 0, {}
    for i, q in enumerate(QUERIES):
        runs = []
        for attempt in ("first", "second"):
            res, vals, wall = run_main(engine, q, want_class, rung)
            st = res.stats
            if i == 0 and attempt == "first":
                require(st.cache_misses >= 1 and st.cache_hits == 0,
                        f"{q}: the first query must build the superblock, stats {st}")
            else:
                require(st.cache_hits == 1 and st.cache_misses == 0 and st.bytes_staged == 0,
                        f"{q} ({attempt} run): expected a superblock cache hit with no "
                        f"staging, stats {st}")
            launches += 1
            runs.append((res, vals, wall))
            print(f"{phase} query {q!r} ({attempt} run, cache hits {st.cache_hits}, misses "
                  f"{st.cache_misses}): grid {want_class}, rung {rung}, "
                  f"{len(res.grids[0].labels)} groups x {res.grids[0].num_steps} steps, "
                  f"{st.series_scanned} series, {st.samples_scanned} samples, "
                  f"{wall * 1e3:.1f} ms end to end, one {RUNGS[rung]} launch")
            require(np.isfinite(vals).all(), f"{q}: non-finite values in the result")
            require((vals > 0).all(), f"{q}: a counter rate must be positive")
        compare(torch.from_numpy(runs[1][1]), torch.from_numpy(runs[0][1]),
                f"{q}: second run vs first", rtol=1e-3)
        timings[q] = {"first_ms": runs[0][2] * 1e3, "second_ms": runs[1][2] * 1e3}
        print(f"{phase} query {q!r}: end to end {runs[0][2] * 1e3:.1f} ms "
              f"{'cold (cache miss)' if i == 0 else '(hit)'} / {runs[1][2] * 1e3:.1f} ms warm "
              f"(hit); the second run's [G, J] equals the first's (rtol 1e-3)")
        results[q] = runs[0][0]
    by_zone = results[QUERIES[1]].grids[0]
    require(sorted(l["zone"] for l in by_zone.labels) == [f"z{i}" for i in range(8)],
            "sum by (zone) must return the 8 zones")
    total = results[QUERIES[0]].grids[0].values_np()
    require(np.allclose(by_zone.values_np().sum(axis=0), total[0], rtol=1e-4),
            "the zones' rates must add up to the global rate")
    print(f"{phase}: the 8 zones' rates add up to the global rate (rtol 1e-4)")
    return {"results": results, "launches": launches, "timings": timings}


def cold_cache(engine) -> None:
    """A fresh superblock cache and empty per-shard staging caches: the
    next query stages from the chunks as a first query does."""
    from filodb_tpu_torch.ops.staging import SuperblockCache

    ms = engine.memstore
    ms._superblock_cache = SuperblockCache()
    for s in ms.shard_nums(engine.dataset):
        shard = ms.shard(engine.dataset, s)
        with shard._lock:
            shard._clear_stage_cache()


def exec_node(engine, q: str, end_s: float = END_S):
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    return engine.planner.materialize(query_range_to_logical_plan(q, START_S, end_s, STEP_S))


def stage_again(engine, q: str, end_s: float = END_S):
    """The query's exec node and its superblock, built cold again (timed)."""
    import torch

    cold_cache(engine)
    ex = exec_node(engine, q, end_s)
    t0 = time.perf_counter()
    entry = ex.superblock(engine.context())
    torch.cuda.synchronize(engine.device)
    return ex, entry, time.perf_counter() - t0


def superblock_of(engine, q: str, cold: bool):
    """The query's exec node and superblock: built cold again (timed) for
    the phase's first query; the same cached superblock (a hit, None
    seconds) for its second, which selects the same series."""
    if cold:
        return stage_again(engine, q)
    ex = exec_node(engine, q)
    return ex, ex.superblock(engine.context()), None


def staged_note(stage_s) -> str:
    return "cached" if stage_s is None else f"staged in {stage_s:.2f} s (host gather, stage, copy)"


def phase_irregular_path(seed: int, device):
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    t0 = time.perf_counter()
    ms = build_memstore(N_SERIES, N_SAMPLES, seed, "irregular")
    print(f"phase4 ingest: {N_SERIES} irregular series x {N_SAMPLES} samples on {N_SHARDS} "
          f"shards in {time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    require(engine.device == device, f"the engine runs on {engine.device}, not {device}")
    run = run_queries(engine, "phase4", "window_stats")

    per_query, err, row, ws_row = {}, 0.0, None, None
    for q in QUERIES:
        ex, entry, stage_s = superblock_of(engine, q, cold=q == QUERIES[0])
        block = entry.block
        gids, G, params = path_args(entry, ex)
        acc, cnt = GA.accumulators(ex.op, G, pad_steps(params.num_steps), device)
        gpu_sample(f"phase4 {q!r} before")
        dev_ms = cuda_ms(lambda: device_path(entry, ex), reps=20)
        dev_b2b = back_to_back_ms(lambda: device_path(entry, ex))
        def kernel():
            WS._launch_range(ex.function, ex.op, block, gids, G, params, entry.is_counter,
                             entry.is_delta, acc, cnt)

        k_ms = cuda_ms(kernel, reps=20)
        k_b2b = back_to_back_ms(kernel)
        gpu_sample(f"phase4 {q!r} after")
        plan = WS.LAST_PLAN
        got = torch.as_tensor(run["results"][q].grids[0].values_np(), device=device)
        err = max(err, compare(got, window_range_path(entry, ex, plain=True), q, rtol=1e-3))
        n, J = len(entry.labels), ex.num_steps()
        real = int(block.lens.sum())
        # ts + vals + raw per real sample, lens + gids per series, [G, J] out
        need = real * 12 + n * 12 + G * J * 4
        bound_ms = need / HBM_BYTES_PER_S * 1e3
        print(f"phase4 {q!r}: superblock {list(block.shape)} {staged_note(stage_s)}; "
              f"[G, J] matches the plain path (rtol 1e-3); "
              f"window_range kernel {k_ms:.4f} ms (median of 20; {k_b2b:.4f} ms back to back; "
              f"{plan.partials} partials, {plan.rows} rows per tile), device path (kernel + "
              f"[G, J] finish) {dev_ms:.4f} ms ({dev_b2b:.4f} ms back to back), "
              f"bound {bound_ms:.4f} ms ({need} bytes at 3.35 TB/s: {real} real samples, "
              f"{n} series, {G} groups x {J} steps)")
        per_query[q] = {"kernel_ms": k_ms, "kernel_ms_back_to_back": k_b2b,
                        "device_path_ms": dev_ms, "device_path_ms_back_to_back": dev_b2b,
                        "bound_ms": bound_ms, "groups": G,
                        "partials": plan.partials}
        if row is None:
            p_ms = cuda_ms(lambda: window_range_path(entry, ex, plain=True), reps=3, warmup=1)
            print(f"phase4 window_range plain (window_stats_plain -> finish -> segment "
                  f"aggregate) {p_ms:.2f} ms")
            row = {
                "name": "window_range",
                "route": "cuda",
                "source": "filodb_tpu_torch/csrc/window_stats.cu",
                "replaces": "filodb_tpu/ops/pallas_kernels.py:33",
                "launches": run["launches"],
                "max_abs_err": 0.0,
                "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
            }
            gpu_sample("phase4 window_stats before")
            ws_row = time_window_stats(block, n, ex, j_pad=pad_steps(J))
            gpu_sample("phase4 window_stats after")
    row["max_abs_err"] = err
    row["queries"] = per_query
    return row, ws_row, engine, run["results"][QUERIES[0]].grids[0].values_np()


def time_window_stats(block, n_series: int, ex, j_pad: int) -> dict:
    """The nine-plane kernel vs plain at the main path's shape, with the
    kernel's time and its bound: the bytes the function needs, each real
    sample's ts, value and raw value and each series' length read once,
    and the nine planes written once at [n_series, num_steps]. The padded
    rows and steps the kernel also writes are printed as a second, padded
    bound. It is not on the main path: 0 launches there."""
    from filodb_tpu_torch.ops import window_stats as WS

    S, T = block.ts.shape
    start_off = ex.start_ms - block.base_ms
    args = (block.ts, block.vals, block.raw, block.lens, start_off, ex.step_ms,
            ex.window_ms, j_pad)
    err = compare_stats(WS.window_stats(*args), WS.window_stats_plain(*args))
    k_ms = cuda_ms(lambda: WS.window_stats(*args), reps=20)
    p_ms = cuda_ms(lambda: WS.window_stats_plain(*args), reps=3, warmup=1)
    J = ex.num_steps()
    real = int(block.lens.sum())
    in_bytes = real * 12 + n_series * 4  # ts+vals+raw per real sample, lens per series
    need_bytes = in_bytes + 9 * n_series * J * 4
    padded_bytes = in_bytes + 9 * S * j_pad * 4
    bound_ms = need_bytes / HBM_BYTES_PER_S * 1e3
    padded_ms = padded_bytes / HBM_BYTES_PER_S * 1e3
    print(f"phase4 window_stats (nine planes) kernel: {k_ms:.4f} ms (median of 20), plain "
          f"{p_ms:.2f} ms, bound {bound_ms:.4f} ms ({need_bytes} bytes at 3.35 TB/s; padded "
          f"bound {padded_ms:.4f} ms, {padded_bytes} bytes), max_abs_err vs plain {err:.3g}")
    return {
        "name": "window_stats",
        "route": "cuda",
        "source": "filodb_tpu_torch/csrc/window_stats.cu",
        "replaces": "filodb_tpu/ops/pallas_kernels.py:33",
        "launches": 0,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def regular_bound_bytes(wm, n_series: int, num_steps: int, G: int, func: str) -> int:
    """Bytes the function must move over the real rows and steps, from the
    query's window bounds: the 32-byte sectors of a row's vals (and raw,
    for the counter zero-crossing cap) that it reads, times the rows (rows
    are 32-byte aligned, so each reads the same sectors); each real row's
    gid; the seven per-step arrays; acc and cnt at [G, num_steps]."""
    lo = wm.lo.cpu().numpy()[:num_steps].astype(np.int64)
    hi = wm.hi.cpu().numpy()[:num_steps].astype(np.int64)
    count = hi - lo
    if func == "rate":
        ok = count >= 2
        vals_pos = np.concatenate([lo[ok], hi[ok] - 1])
        raw_pos = lo[ok]
    else:  # sum_over_time: every sample of every window
        vals_pos = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] + [np.empty(0, np.int64)])
        raw_pos = np.empty(0, np.int64)
    sectors = len(np.unique(vals_pos * 4 // 32)) + len(np.unique(raw_pos * 4 // 32))
    return sectors * 32 * n_series + n_series * 8 + 7 * num_steps * 4 + 2 * G * num_steps * 4


def phase_regular_path(seed: int, device):
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import pad_steps

    t0 = time.perf_counter()
    ms = build_memstore(N_SERIES, N_SAMPLES, seed, "regular")
    print(f"phase5 ingest: {N_SERIES} series x {N_SAMPLES} samples at exactly 10 s "
          f"(bench.py's store) on {N_SHARDS} shards in {time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    run = run_queries(engine, "phase5", "mxu")

    row, per_query = None, {}
    for q in QUERIES:
        ex, entry, stage_s = superblock_of(engine, q, cold=q == QUERIES[0])
        block = entry.block
        gids, G, params = path_args(entry, ex)
        J = ex.num_steps()
        got = torch.as_tensor(run["results"][q].grids[0].values_np(), device=device)
        want = regular_plain(ex.function, ex.op, block, gids, G, params, entry.is_counter)[:, :J]
        err = compare(got, want, f"{q} vs plain", rtol=1e-3)
        compare(got, window_range_path(entry, ex, plain=False), f"{q} vs window stats",
                rtol=1e-3)
        wm = MK.window_matrices(block, ex.start_ms - block.base_ms, ex.step_ms,
                                pad_steps(J), ex.window_ms)
        raw = block.raw if block.raw is not None else block.vals
        acc, cnt = GA.accumulators(ex.op, G, pad_steps(J), device)

        def kernel(func):
            return lambda: MK._launch(func, ex.op, block.vals, raw, gids, G, wm, J,
                                      entry.is_counter, entry.is_delta, acc, cnt)

        gpu_sample(f"phase5 {q!r} before")
        dev_ms = cuda_ms(lambda: device_path(entry, ex), reps=20)
        dev_b2b = back_to_back_ms(lambda: device_path(entry, ex))
        k_ms = cuda_ms(kernel("rate"), reps=20)
        k_b2b = back_to_back_ms(kernel("rate"))
        gpu_sample(f"phase5 {q!r} after")
        plan = MK.LAST_PLAN
        n = len(entry.labels)
        rate_bytes = regular_bound_bytes(wm, n, J, G, "rate")
        bound_ms = rate_bytes / HBM_BYTES_PER_S * 1e3
        print(f"phase5 {q!r}: superblock {list(block.shape)} {staged_note(stage_s)}; "
              f"[G, J] matches the plain path (max_abs_err {err:.3g}) "
              f"and the window-stats rung on the same superblock (rtol 1e-3); regular_range "
              f"kernel {k_ms:.4f} ms (median of 20; {k_b2b:.4f} ms back to back; "
              f"{plan.partials} partials, {plan.rows} rows per tile), device path (kernel + "
              f"[G, J] finish) {dev_ms:.4f} ms ({dev_b2b:.4f} ms back to back), bound "
              f"{bound_ms:.4f} ms ({rate_bytes} bytes at 3.35 TB/s, {G} groups)")
        per_query[q] = {"kernel_ms": k_ms, "kernel_ms_back_to_back": k_b2b,
                        "device_path_ms": dev_ms, "device_path_ms_back_to_back": dev_b2b,
                        "bound_ms": bound_ms, "groups": G,
                        "partials": plan.partials}
        if row is not None:
            continue
        gpu_sample("phase5 sum_over_time before")
        s_ms = cuda_ms(kernel("sum_over_time"), reps=20)
        s_b2b = back_to_back_ms(kernel("sum_over_time"))
        s_dev_ms = cuda_ms(lambda: MK.regular_range_aggregate(
            "sum_over_time", ex.op, block, gids, G, params, entry.is_counter,
            entry.is_delta), reps=20)
        lib_ms = cuda_ms(lambda: torch.matmul(block.vals, wm.W), reps=20)
        gpu_sample("phase5 sum_over_time after")
        p_ms = cuda_ms(lambda: regular_plain("rate", ex.op, block, gids, G, params,
                                             entry.is_counter), reps=3, warmup=1)
        sum_bytes = regular_bound_bytes(wm, n, J, G, "sum_over_time")
        sum_bound_ms = sum_bytes / HBM_BYTES_PER_S * 1e3
        print(f"phase5 regular_range on sum(rate): plain {p_ms:.3f} ms")
        print(f"phase5 regular_range kernel on sum(sum_over_time): {s_ms:.4f} ms (median of 20; "
              f"{s_b2b:.4f} ms back to back), device path (kernel + [G, J] finish) "
              f"{s_dev_ms:.4f} ms (median of 20), "
              f"bound {sum_bound_ms:.4f} ms ({sum_bytes} bytes); torch.matmul(vals, W) "
              f"[{block.shape[0]}, {block.shape[1]}] x [{block.shape[1]}, {pad_steps(J)}] "
              f"(cuBLAS f32, TF32 off) {lib_ms:.4f} ms")
        row = {
            "name": "regular_range",
            "route": "cuda",
            "source": "filodb_tpu_torch/csrc/regular_range.cu",
            "replaces": "filodb_tpu/ops/mxu_kernels.py:250",
            "launches": run["launches"],
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": lib_ms,
            "library_call": "torch.matmul(vals, W): the window sums of sum_over_time",
            "sum_over_time_ms": s_ms,
            "sum_over_time_ms_back_to_back": s_b2b,
            "sum_over_time_device_path_ms": s_dev_ms,
            "sum_over_time_bound_ms": sum_bound_ms,
        }
    row["queries"] = per_query
    warm = []
    for _ in range(WARM_P50_RUNS):
        t1 = time.perf_counter()
        engine.query_range(QUERIES[0], START_S, END_S, STEP_S).grids[0].values_np()
        warm.append(time.perf_counter() - t1)
    row["warm_p50_ms"] = float(np.median(warm)) * 1e3
    print(f"phase5 {QUERIES[0]!r}: warm p50 {row['warm_p50_ms']:.2f} ms over {WARM_P50_RUNS} "
          f"runs (phase 14's reference)")
    ex, entry, _ = superblock_of(engine, QUERIES[0], cold=False)
    row["b5"] = time_b5_codes(entry, ex, device)
    return row, engine


def time_b5_codes(entry, ex, device) -> dict:
    """The regular kernel's B5 codes at the main path's shape, on phase 5's
    superblock, in the store mode the tree takes: each against its plain
    version (counts exact, else rtol 2e-4 / atol 1e-4) and timed back to
    back alternating with the rung the port took before (general for
    changes, resets, deriv and predict_linear; window stats for min/max and
    absent_over_time), beside the bound (every real sample's value read
    once, gids, the [J, n] values written once) and the plain ms."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    block, J = entry.block, ex.num_steps()
    _, _, params = path_args(entry, ex)
    gids, n = AGG.zero_gids(block), block.n_series
    S, j_pad = block.vals.shape[0], pad_steps(J)
    wm = MK.window_matrices(block, params.start_ms - block.base_ms, params.step_ms, j_pad,
                            params.window_ms)
    raw = block.raw if block.raw is not None else block.vals
    bound_bytes = int(block.lens[:n].sum()) * 4 + n * 8 + n * J * 4
    out = {"bound_bytes": bound_bytes, "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3}
    flags = (entry.is_counter, entry.is_delta)
    for func in B5_FUNCS:
        args = (600.0,) if func == "predict_linear" else ()
        got = MK.regular_range_series(func, block, gids, 1, params, *flags, args=args)
        want = GA.series_grid(AGG.rung_series_plain("mxu", func, block, params, *flags, args),
                              gids, 1, J)
        exact = func in EXACT_FUNCS
        err = compare(got[:J], want[:J], f"phase5 {func} store vs plain",
                      rtol=0 if exact else 2e-4, atol=0 if exact else 1e-4)
        buf, buf2 = (GA.series_buffer(S, j_pad, J, device) for _ in range(2))
        new = lambda: MK._launch(func, GA.STORE, block.vals, raw, gids, 1, wm, J,  # noqa: E731
                                 *flags, buf, buf, args=args)
        other = "general" if func in GR.TREE_FUNCS else "window_stats"
        if other == "general":
            old = lambda: GR._launch(func, GA.STORE, block, gids, 1, params,  # noqa: E731
                                     *flags, buf2, buf2, args=args)
        else:
            old = lambda: WS._launch_range(func, GA.STORE, block, gids, 1,  # noqa: E731
                                           params, *flags, buf2, buf2)
        times = {"new": [], "old": []}
        gpu_sample(f"phase5 B5 {func} before")
        for which in ("new", "old", "new", "old"):
            times[which].append(back_to_back_ms(new if which == "new" else old, reps=20))
        ms_call = cuda_ms(new, reps=20)
        gpu_sample(f"phase5 B5 {func} after")
        plain_ms = cuda_ms(lambda: AGG.rung_series_plain("mxu", func, block, params, *flags,
                                                         args), reps=1, warmup=0)
        out[func] = {"max_abs_err": err, "ms": ms_call, "ms_back_to_back": times["new"],
                     "replaced_rung": other, "replaced_ms_back_to_back": times["old"],
                     "plain_ms": plain_ms}
        print(f"phase5 B5 {func} (store mode, {n} series x {J} steps): equals plain "
              f"(max_abs_err {err:.3g}); {ms_call:.4f} ms (median of 20), back to back "
              f"{times['new'][0]:.4f} / {times['new'][1]:.4f} against {other}'s "
              f"{times['old'][0]:.4f} / {times['old'][1]:.4f} alternating; bound "
              f"{out['bound_ms']:.4f} ms ({bound_bytes} bytes); plain {plain_ms:.2f} ms")
    return out


def live_batch(b: int, grid: str, tags_list, rng):
    """bench.py's ingest_impact batch ``b``: one sample per series at the
    next slot, value 1e9 + 10 (N_SAMPLES + b + 1), above every series'
    build-time values; on the jittered grid the next nominal slot +-4 % of
    the interval, per series."""
    from filodb_tpu_torch.core.records import RecordBatch
    from filodb_tpu_torch.core.schemas import PROM_COUNTER

    n = len(tags_list)
    ts = np.full(n, BASE + (N_SAMPLES + b) * 10_000, np.int64)
    if grid == "jitter":
        ts += JITTER_PHASE_MS + np.rint(rng.uniform(-0.04, 0.04, n) * 10_000).astype(np.int64)
    vals = np.full(n, 1e9 + 10.0 * (N_SAMPLES + b + 1))
    return RecordBatch(PROM_COUNTER, ts, {"count": vals}, tags_list)


def extension_record() -> dict:
    """The last superblock extension's sizes and times: host work (the
    row-set proof, the per-series tail reads, the checks and mirror
    writes) and device work (clones and uploads, between CUDA events)."""
    import torch

    from filodb_tpu_torch.ops import staging as ST

    ext = dict(ST.LAST_EXTENSION)
    events = ext.pop("device_events", None)  # absent on a CPU rehearsal
    torch.cuda.synchronize()
    return {"bytes_uploaded": ext["bytes_uploaded"], "columns": ext["columns"],
            "series": ext["series"], "proof_ms": ext["proof_s"] * 1e3,
            "tail_read_ms": ext["read_s"] * 1e3, "host_ms": ext["host_s"] * 1e3,
            "device_ms": events[0].elapsed_time(events[1]) if events else float("nan"),
            "device_wall_ms": ext["device_wall_s"] * 1e3}


def phase_live_edge(engine, device, phase: str, grid: str, n_idle: int, n_busy: int,
                    min_batches: int, seed: int) -> dict:
    """bench.py's ingest_impact on the port at full size: one cold query of
    ``sum(rate(...[5m]))`` to the live edge, ``n_idle`` warm queries, then
    queries back to back while a thread ingests one sample per series
    every 100 ms through ``ingest_routed``: at least ``n_busy`` of them,
    and on until ``min_batches`` batches have landed (a 100k-row batch
    takes the host longer than ``n_busy`` warm queries do, and a busy query
    that no batch reached measures nothing). Every query must launch its rung's
    kernel once; the stream must extend the cached superblock at least once
    and never restage. After the stream, one more batch: the query held on
    the block from before that last extension must return what it did, and
    the final [G, J] must match the plain path on a superblock built afresh
    from the final store, whose real ts and lens must equal the extended
    block's bit for bit, and vals and raw within rtol 1e-6."""
    import threading

    import torch

    from filodb_tpu_torch import metrics as M

    rung = "mxu" if grid == "regular" else "jitter"
    ms = engine.memstore
    n_series = sum(len(sh.partitions) for sh in ms.shards("prometheus"))
    tags_list = [series_tags(i) for i in range(n_series)]
    rng = np.random.default_rng(seed + 7)
    ev0 = M.superblock_events()
    launches = [0]

    def query():
        launches[0] += 1  # run_main requires exactly one launch per query
        return run_main(engine, LIVE_QUERY, grid, rung, end_s=LIVE_END_S)

    res, cold_vals, cold_s = query()
    require(res.stats.cache_misses >= 1, f"{phase}: the first live-edge query must build, "
                                         f"stats {res.stats}")
    idle = []
    for _ in range(n_idle):
        res, _, wall = query()
        require(res.stats.cache_hits == 1 and res.stats.cache_misses == 0,
                f"{phase}: an idle query must hit the cache, stats {res.stats}")
        idle.append(wall)
    stop, sent, errors, ingest_s = threading.Event(), [0], [], []

    def ingester():
        try:
            while not stop.is_set() and sent[0] < MAX_BATCHES - 1:
                batch = live_batch(sent[0], grid, tags_list, rng)
                t0 = time.perf_counter()
                ms.ingest_routed("prometheus", batch, spread=SPREAD)
                ingest_s.append(time.perf_counter() - t0)
                sent[0] += 1
                stop.wait(0.1)
        except BaseException as e:  # noqa: BLE001 -- reported by the main thread
            errors.append(e)

    th = threading.Thread(target=ingester)
    busy, extensions = [], []
    th.start()
    try:
        while len(busy) < n_busy or (sent[0] < min_batches and th.is_alive()):
            res, _, wall = query()
            busy.append(wall)
            if res.stats.cache_extends:
                extensions.append(extension_record())
        busy_batches = sent[0]
    finally:
        stop.set()
        th.join()
    require(not errors, f"{phase}: the ingester failed: {errors!r}")
    require(sent[0] > 0, f"{phase}: the ingester sent no batch")
    # settle on everything sent, hold that block, then one last extension
    query()
    ex = exec_node(engine, LIVE_QUERY, LIVE_END_S)
    held = ex.superblock(engine.context())
    names = ("ts", "vals", "raw", "lens")
    held_arrays = {k: getattr(held.block, k).clone() for k in names}
    held_out = device_path(held, ex).clone()
    ms.ingest_routed("prometheus", live_batch(sent[0], grid, tags_list, rng), spread=SPREAD)
    sent[0] += 1
    res, final_vals, _ = query()
    require(res.stats.cache_extends == 1, f"{phase}: the last batch must extend, {res.stats}")
    extensions.append(extension_record())
    for k in names:
        require(torch.equal(getattr(held.block, k), held_arrays[k]),
                f"{phase}: the extension wrote the held block's {k}")
    compare(device_path(held, ex), held_out, f"{phase}: held block after the extension",
            rtol=1e-3)
    events = {k: v - ev0[k] for k, v in M.superblock_events().items()}
    require(events["extend"] >= 1 and events["restage"] == 0 and events["extend_abort"] == 0,
            f"{phase}: maintenance outcomes {events}")
    extended = ex.superblock(engine.context())
    ext_block = extended.block
    require(int(ext_block.lens[0]) == int(held.block.lens[0]) + 1,
            f"{phase}: the extended superblock holds {int(ext_block.lens[0])} samples per series")
    # the final store, built afresh
    ex, fresh, fresh_s = stage_again(engine, LIVE_QUERY, LIVE_END_S)
    fb, n = fresh.block, fresh.block.n_series
    require(fb.shape == ext_block.shape and n == ext_block.n_series,
            f"{phase}: fresh superblock {fb.shape} vs extended {ext_block.shape}")
    if grid == "jitter":  # the window structure's inputs: one nominal grid, one bound
        require(np.array_equal(fb.nominal_ts, ext_block.nominal_ts)
                and fb.maxdev_ms == ext_block.maxdev_ms,
                f"{phase}: the extended nominal grid or deviation bound differs from a fresh "
                f"build's")
    require(torch.equal(fb.ts[:n], ext_block.ts[:n]) and torch.equal(fb.lens, ext_block.lens),
            f"{phase}: the extended superblock's ts or lens differ from a fresh build's")
    real = torch.arange(fb.shape[1], device=device)[None, :] < fb.lens[:n, None]
    diffs = {}
    for k in ("vals", "raw"):
        got, want = getattr(ext_block, k)[:n][real], getattr(fb, k)[:n][real]
        diffs[k] = compare(got, want, f"{phase}: extended {k} vs fresh", rtol=1e-6)
    if grid == "regular":
        gids, G, params = path_args(fresh, ex)
        want = regular_plain(ex.function, ex.op, fb, gids, G, params, fresh.is_counter)
        want = want[:, : ex.num_steps()]
    else:
        gids, G, params = path_args(fresh, ex)
        want = plain_fused(ex.function, ex.op, fb, gids, G, params, fresh.is_counter)
        want = want[:, : ex.num_steps()]
        compare(want, window_range_path(fresh, ex, plain=True),
                f"{phase}: the jitter rung's plain path vs the window-stats rung's", rtol=1e-3)
    final_err = compare(torch.from_numpy(final_vals).to(device), want,
                        f"{phase}: final query vs the plain path on a fresh build", rtol=1e-3)
    idle_ms, busy_ms = float(np.mean(idle)) * 1e3, float(np.mean(busy)) * 1e3
    per = extensions[-1]
    busy_ext = len(extensions) - 1
    print(f"{phase} live edge ({grid}, {n_series} series, {LIVE_QUERY!r} to {LIVE_END_S:.0f} s): "
          f"cold {cold_s * 1e3:.1f} ms, idle mean {idle_ms:.2f} ms over {n_idle}, busy mean "
          f"{busy_ms:.2f} ms over {len(busy)} ({busy_ext} of them extended the superblock, "
          f"{busy_batches} batches landed meanwhile), busy/idle {busy_ms / idle_ms:.2f} x; "
          f"{sent[0]} batches in all, {np.mean(ingest_s):.2f} s per {n_series}-row ingest_routed "
          f"(mean of {len(ingest_s)}), outcomes {events}")
    for i, e in enumerate(extensions):
        print(f"{phase} extension {i}: {e['series']} series x {e['columns']} columns, "
              f"{e['bytes_uploaded']} bytes uploaded; host {e['proof_ms'] + e['host_ms']:.1f} ms "
              f"(row-set proof {e['proof_ms']:.1f}, tail reads {e['tail_read_ms']:.1f}, "
              f"the rest {e['host_ms'] - e['tail_read_ms']:.1f}); device {e['device_ms']:.3f} ms "
              f"between events ({e['device_wall_ms']:.2f} ms host wall)")
    print(f"{phase}: held block unchanged; final [G, J] matches the plain path on a fresh "
          f"build (max_abs_err {final_err:.3g}, fresh build {fresh_s:.2f} s); extended ts and "
          f"lens bit-equal to the fresh build's, vals max diff {diffs['vals']:.3g}, raw "
          f"{diffs['raw']:.3g}")
    return {
        "grid": grid, "series": n_series, "cold_ms": cold_s * 1e3, "idle_mean_ms": idle_ms,
        "busy_mean_ms": busy_ms, "busy_over_idle": busy_ms / idle_ms, "idle_ms": [
            t * 1e3 for t in idle], "busy_ms": [t * 1e3 for t in busy], "batches": sent[0],
        "busy_batches": busy_batches, "busy_extensions": busy_ext,
        "ingest_s_per_batch": ingest_s,
        "outcomes": events, "extensions": extensions, "fresh_build_s": fresh_s,
        "vals_max_diff": diffs["vals"], "raw_max_diff": diffs["raw"],
        "final_max_abs_err": final_err, "launches": launches[0],
    }


# ---- the general rung (B4): phase 2c and phase 8 ----

GENERAL_STAGINGS = {  # staging mode -> (stage_series flags, is_counter, is_delta)
    "gauge": ({}, False, False), "corrected": ({"counter_corrected": True}, True, False),
    "shifted": ({"subtract_baseline": True}, True, False),
    "diff": ({"diff_encode": True}, True, False), "delta": ({}, True, True),
}


def general_block(staging: str, n_real: int, n: int, rng, device, grid: str = "irregular"):
    """``n_real`` seeded series staged by the port in a staging mode, padded
    rows past them (the trash group): irregular (5-15 s apart with a tie
    every 31 samples in every fifth row, ragged lengths, a row with no
    sample) or all ``n`` samples on one 10 s grid (a block with shared
    bounds); gauges (NaN samples in every third row, which staging drops as
    it drops stale markers), counters with a reset in every fourth row, or
    delta increments (some zero)."""
    from filodb_tpu_torch.ops.staging import stage_series

    mode, counter, is_delta = GENERAL_STAGINGS[staging]
    series = []
    for i in range(n_real):
        if grid == "regular":
            m = n
            ts = BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000
        else:
            m = 0 if i == n_real // 2 else int(rng.integers(n // 2, n + 1))
            gaps = rng.integers(5_000, 15_001, m)
            if i % 5 == 0:
                gaps[7::31] = 0
            ts = BASE + int(rng.integers(0, 20_000)) + np.cumsum(gaps).astype(np.int64)
        if is_delta:
            vals = rng.uniform(0, 10, m)
            vals[3::7] = 0.0
        elif counter:
            vals = np.cumsum(rng.uniform(0, 10, m)) + 1e3
            if i % 4 == 0 and m:
                vals[m // 2:] -= vals[m // 2] - rng.uniform(0, 5)
        else:
            vals = 50 + 20 * rng.standard_normal(m)
            if i % 3 == 0 and grid != "regular":
                vals[11::17] = np.nan
        series.append((ts, vals))
    block = stage_series(series, BASE, **mode)
    require((block.regular_ts is not None) == (grid == "regular"), f"{grid} {staging} block")
    return block.to_device(device), counter, is_delta


def phase_general_vs_plain(seed: int, device) -> float:
    """The general kernel against ``general_range_aggregate_plain``; returns
    the largest absolute difference."""
    import torch

    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops.kernels import RangeParams

    rng = np.random.default_rng(seed + 3)
    n_real, n = 300, 380
    # from 200 s before the first sample to past the last one: empty windows
    params = RangeParams(BASE - 200_000, 60_000, 80, WINDOW_MS)
    worst = 0.0
    for staging, grid in itertools.product(GENERAL_STAGINGS, ("irregular", "regular")):
        block, counter, is_delta = general_block(staging, n_real, n, rng, device, grid)
        S = block.ts.shape[0]
        for G in (1, 8, 120, n_real):
            gids = torch.full((S,), G, dtype=torch.int64, device=device)
            own = G == n_real
            gids[:n_real] = (torch.arange(n_real, device=device) if own else
                             torch.from_numpy(rng.integers(0, G, n_real)).to(device))
            plans = set()
            for func in sorted(GR.GENERAL_FUNCS):
                for op in ("sum", "count", "avg", "min", "max"):
                    got = GR.general_range_aggregate(func, op, block, gids, G, params,
                                                     is_counter=counter, is_delta=is_delta)
                    plans.add((GR.LAST_PLAN.partials, GR.LAST_PLAN.shared_bounds))
                    want = GR.general_range_aggregate_plain(func, op, block, gids, G, params,
                                                            is_counter=counter,
                                                            is_delta=is_delta)
                    what = f"{op}({func}) G={G} {staging} {grid}"
                    if func in ("changes", "resets"):  # integer counts: bit-equal
                        err = compare(got, want, what, rtol=0.0)
                    elif own:
                        err = compare(got, want, what, rtol=2e-4, atol=1e-4)
                    else:
                        finite = want[torch.isfinite(want)]
                        scale = float(finite.abs().max()) if finite.numel() else 0.0
                        err = compare(got, want, what, rtol=1e-3, atol=1e-5 * scale)
                    worst = max(worst, err)
            want_plan = ("shared" if G <= 8 else "global", grid == "regular")
            require(plans == {want_plan}, f"G={G} {grid}: (partials, shared bounds) {plans}")
            plan = GR.LAST_PLAN
            print(f"phase2c {staging} {grid} block {list(block.shape)} ({n_real} real rows) "
                  f"G={G}: {len(GR.GENERAL_FUNCS)} functions x 5 ops match plain (changes/resets "
                  f"bit-equal; {want_plan[0]} partials, shared bounds {want_plan[1]}, "
                  f"{plan.warps} warps, {plan.n_arrays} arrays staged)")
    print(f"phase2c general kernel matches plain, max_abs_err={worst:.3g}")
    return worst


# phase 8: (query, rung, what its first run must be on phase 4's cache)
GENERAL_QUERIES = (
    ("sum(irate(http_requests_total[5m]))", "general", "hit"),  # corrected: phase 4's block
    ("sum by (zone) (changes(http_requests_total[5m]))", "general", "build"),  # diff
    ("sum(resets(http_requests_total[5m]))", "general", "hit"),
    ("sum(deriv(http_requests_total[5m]))", "general", "build"),  # shifted
    ("sum by (zone) (stddev_over_time(http_requests_total[5m]))", "general", "hit"),
    ("sum(rate(http_requests_total[5m] offset 1m))", "window_stats", "build"),
)
REGULAR_GENERAL_QUERY = "sum(changes(http_requests_total[5m]))"
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
F64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores (NVIDIA data sheet)
# operations per in-window sample of the general kinds, and their peak rate
GENERAL_OPS = {"irate": (0, F32_OPS_PER_S), "idelta": (0, F32_OPS_PER_S),
               "stddev_over_time": (4, F32_OPS_PER_S), "stdvar_over_time": (4, F32_OPS_PER_S),
               "z_score": (4, F32_OPS_PER_S), "changes": (2, F32_OPS_PER_S),
               "resets": (2, F32_OPS_PER_S), "deriv": (6, F64_OPS_PER_S)}


def general_bound(entry, ex, G: int) -> dict:
    """The least time of one general launch at the query's shape: bytes
    (ts and vals per real sample, and raw where the launch stages it; lens
    and gids per series, [G, J] out) over 3.35 TB/s, or the in-window
    samples' operations (this run's windows) over the peak rate of their
    type, whichever is larger."""
    import torch

    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops.kernels import _bounds

    block = entry.block
    n, J = len(entry.labels), ex.num_steps()
    real = int(block.lens.sum())
    raw = block.raw if block.raw is not None else block.vals
    arrays = GR.staged_arrays(ex.function, entry.is_counter, entry.is_delta,
                              distinct_raw=raw.data_ptr() != block.vals.data_ptr())
    need = real * 4 * arrays + n * 12 + G * J * 4
    dev = block.ts.device
    start = int(ex.start_ms - ex.offset_ms - block.base_ms)
    out_t = (start + torch.arange(J, device=dev, dtype=torch.int64) * ex.step_ms).to(torch.int32)
    lo, hi = _bounds(block.ts[:n], block.lens[:n], out_t,
                     torch.tensor(ex.window_ms, dtype=torch.int32, device=dev))
    samples = int((hi - lo).clamp(min=0).sum())
    per_sample, rate = GENERAL_OPS[ex.function]
    ops = samples * per_sample + n * J * 10  # ~10 operations per (row, step) besides
    bytes_ms, ops_ms = need / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations", "bound_bytes": need, "bytes_ms": bytes_ms, "operations": ops,
            "operations_ms": ops_ms, "window_samples": samples}


def general_plain(entry, ex):
    """The general rung's plain version on the exec node's superblock,
    sliced to the query's steps."""
    from filodb_tpu_torch.ops import general_range as GR

    gids, G, params = path_args(entry, ex)
    out = GR.general_range_aggregate_plain(ex.function, ex.op, entry.block, gids, G, params,
                                           is_counter=entry.is_counter, is_delta=entry.is_delta)
    return out[:, : ex.num_steps()]


def run_general_query(engine, q: str, rung: str, first: str, grid: str, phase: str,
                      card: str) -> dict:
    """One query of the general phase: cold (or a hit on an earlier
    query's superblock) then warm, one launch each on ``rung``; its
    [G, J] against the plain path; the kernel and device path timed."""
    import torch

    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops.kernels import pad_steps

    runs = []
    for attempt in ("first", "second"):
        res, vals, wall = run_main(engine, q, grid, rung)
        st = res.stats
        if attempt == "first" and first == "build":
            require(st.cache_misses >= 1 and st.cache_hits == 0,
                    f"{q}: the first run must build its superblock, stats {st}")
        else:
            require(st.cache_hits == 1 and st.cache_misses == 0 and st.bytes_staged == 0,
                    f"{q} ({attempt} run): expected a superblock cache hit with no staging, "
                    f"stats {st}")
        require(np.isfinite(vals).all(), f"{q}: non-finite values in the result")
        runs.append((res, vals, wall))
        if rung == "general":  # one [steps] bounds table per block exactly on a shared grid
            require(GR.LAST_PLAN.shared_bounds == (grid == "regular"),
                    f"{q}: shared bounds {GR.LAST_PLAN.shared_bounds} on a {grid} store")
    compare(torch.from_numpy(runs[1][1]), torch.from_numpy(runs[0][1]),
            f"{q}: second run vs first", rtol=1e-3)
    ex = exec_node(engine, q)
    entry = ex.superblock(engine.context())
    got = torch.as_tensor(runs[0][1], device=engine.device)
    plain = (window_range_path(entry, ex, plain=True) if rung == "window_stats"
             else general_plain(entry, ex))
    err = compare(got, plain, f"{q} vs plain", rtol=1e-3)
    block = entry.block
    gids, G, params = path_args(entry, ex)
    acc, cnt = GA.accumulators(ex.op, G, pad_steps(params.num_steps), engine.device)
    kernel = None
    if rung == "general":
        def kernel():
            GR._launch(ex.function, ex.op, block, gids, G, params, entry.is_counter,
                       entry.is_delta, acc, cnt)
    gpu_sample(f"{phase} {q!r} before")
    dev_ms = cuda_ms(lambda: device_path(entry, ex), reps=20)
    dev_b2b = back_to_back_ms(lambda: device_path(entry, ex))
    out = {"rung": rung, "groups": G, "first_ms": runs[0][2] * 1e3,
           "warm_ms": runs[1][2] * 1e3, "first_run": first, "device_path_ms": dev_ms,
           "device_path_ms_back_to_back": dev_b2b, "max_abs_err": err,
           "launches": 2}
    if kernel is not None:
        out["kernel_ms"] = cuda_ms(kernel, reps=20)
        out["kernel_ms_back_to_back"] = back_to_back_ms(kernel)
        out["plain_ms"] = cuda_ms(lambda: general_plain(entry, ex), reps=3, warmup=1)
        out.update(general_bound(entry, ex, G))
        out["partials"] = GR.LAST_PLAN.partials
        out["layout"] = (f"{GR.LAST_PLAN.warps} warps per block, "
                         f"shared bounds {GR.LAST_PLAN.shared_bounds}")
    gpu_sample(f"{phase} {q!r} after")
    kern = (f"general kernel {out['kernel_ms']:.4f} ms (median of 20; "
            f"{out['kernel_ms_back_to_back']:.4f} ms back to back; {out['partials']} partials, "
            f"{out['layout']}), bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']}: {out['bound_bytes']} bytes at 3.35 TB/s = "
            f"{out['bytes_ms']:.4f} ms; {out['operations']} operations = "
            f"{out['operations_ms']:.4f} ms), plain {out['plain_ms']:.2f} ms"
            if kernel is not None else "window_range kernel (phase 4 times it)")
    print(f"{phase} query {q!r}: rung {rung}, {G} groups x {ex.num_steps()} steps, superblock "
          f"{list(block.shape)}; first run ({first}) {out['first_ms']:.1f} ms, warm (hit) "
          f"{out['warm_ms']:.1f} ms end to end; one launch each; [G, J] matches the plain path "
          f"(max_abs_err {err:.3g}, rtol 1e-3); {kern}; device path {dev_ms:.4f} ms "
          f"({dev_b2b:.4f} ms back to back) on {card}")
    out["result"] = runs[0][1]
    return out


def phase_general_path(engine, card: str, rate_result: np.ndarray) -> dict:
    """Phase 8 on phase 4's irregular store: the general rung's queries
    and an offset query, each cold (or a hit) then warm."""
    per_query = {}
    for q, rung, first in GENERAL_QUERIES:
        per_query[q] = run_general_query(engine, q, rung, first, "irregular", "phase8", card)
    for q in (GENERAL_QUERIES[0][0], GENERAL_QUERIES[4][0]):  # irate, stddev_over_time
        require((per_query[q]["result"] > 0).all(), f"{q}: must be positive")
    changes = per_query[GENERAL_QUERIES[1][0]]["result"]
    require((changes > 0).all() and (changes == np.round(changes)).all(),
            "changes: positive whole counts")
    resets = per_query[GENERAL_QUERIES[2][0]]["result"]
    require((resets == 0).all(), "resets: phase 4's counters never reset")
    require((per_query[GENERAL_QUERIES[3][0]]["result"] > 0).all(), "deriv must be positive")
    # offset 1m on 60 s steps: the same windows one step earlier
    import torch

    shifted = per_query[GENERAL_QUERIES[5][0]]["result"]
    compare(torch.from_numpy(shifted[:, 1:]), torch.from_numpy(rate_result[:, :-1]),
            "offset 1m vs sum(rate) one step earlier", rtol=1e-3)
    print("phase8 sum(rate(...[5m] offset 1m)) equals phase 4's sum(rate) one step earlier "
          "(rtol 1e-3)")
    for v in per_query.values():
        del v["result"]
    return per_query


def phase_general_regular(engine, card: str) -> dict:
    """Phase 8 on phase 5's regular store: changes, which the JAX package
    also runs on its general kernel on a regular grid."""
    out = run_general_query(engine, REGULAR_GENERAL_QUERY, "general", "build", "regular",
                            "phase8", card)
    require((out.pop("result") > 0).all(), "changes: positive counts")
    return out


# ---- phase 9: the fused epilogues (B9) ----

# (query, rung) on phase 4's irregular store, then on phase 5's regular one
EPILOGUE_IRREGULAR = (
    ("topk(5, rate(http_requests_total[5m]))", "window_stats"),
    ("bottomk(5, irate(http_requests_total[5m]))", "general"),
    ("quantile(0.99, rate(http_requests_total[5m]))", "window_stats"),
    ("quantile by (zone) (0.5, stddev_over_time(http_requests_total[5m]))", "general"),
    ("topk(1000, rate(http_requests_total[5m]))", "window_stats"),
    ("quantile by (instance) (0.5, rate(http_requests_total[5m]))", "window_stats"),
)
EPILOGUE_REGULAR = (
    ("topk(10, rate(http_requests_total[5m]))", "mxu"),
    ("quantile by (zone) (0.9, rate(http_requests_total[5m]))", "mxu"),
)
ORDER_KERNELS = {"topk_steps": "filodb_tpu/ops/aggregations.py:1904",
                 "segment_quantile": "filodb_tpu/ops/aggregations.py:1923"}


def epilogue_params(ex):
    from filodb_tpu_torch.ops.kernels import RangeParams

    return RangeParams(ex.start_ms - ex.offset_ms, ex.step_ms, ex.num_steps(), ex.window_ms)


def series_plain(entry, ex, rung: str):
    """The rung's plain per-series grid on the exec node's superblock, in
    the store mode's layout ([J_pad, S_pad], padded rows and steps NaN)."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA

    block, params, func = entry.block, epilogue_params(ex), ex.function or "last"
    sj = AGG.rung_series_plain(rung, func, block, params, entry.is_counter, entry.is_delta)
    return GA.series_grid(sj, AGG.zero_gids(block), 1, params.num_steps)


def jitter_launch(variant: str, func: str, block, gids, G: int, params, is_counter: bool,
                  is_delta: bool, op: str, out, cnt):
    """One launch of the jitter kernel (``variant`` jitter or masked) alone,
    as a closure: the store mode (``op`` STORE) or the aggregate ``op``."""
    from filodb_tpu_torch.ops import mxu_jitter as JR

    masked = variant == "masked"
    wm, planes = JR._prepare(masked, func, block, params, gids)
    return lambda: JR._launch(masked, func, op, planes, gids, G, wm, params.num_steps,
                              is_counter, is_delta, JR._maxdev(masked, block), out, cnt)


def store_launch(entry, ex, rung: str, op: str, out, cnt):
    """The rung's kernel alone, in the store mode (``op`` STORE, into
    ``out``) or as the aggregate ``op`` of one group (into ``out``/``cnt``)."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    block, params, func = entry.block, epilogue_params(ex), ex.function or "last"
    gids = AGG.zero_gids(block)
    if rung in ("jitter", "masked"):
        return jitter_launch(rung, func, block, gids, 1, params, entry.is_counter,
                             entry.is_delta, op, out, cnt)
    if rung == "mxu":
        wm = MK.window_matrices(block, params.start_ms - block.base_ms, params.step_ms,
                                pad_steps(params.num_steps), params.window_ms)
        raw = block.raw if block.raw is not None else block.vals
        return lambda: MK._launch(func, op, block.vals, raw, gids, 1, wm, params.num_steps,
                                  entry.is_counter, entry.is_delta, out, cnt)
    launch = WS._launch_range if rung == "window_stats" else GR._launch
    return lambda: launch(func, op, block, gids, 1, params, entry.is_counter, entry.is_delta,
                          out, cnt)


def store_bound_bytes(entry, ex, rung: str) -> int:
    """The least bytes of a store-mode launch: what the rung reads (as its
    own bound counts it) and the real series' values at the real steps
    written once ([J, n] of the [J_pad, S_pad] grid)."""
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import pad_steps

    block, J = entry.block, ex.num_steps()
    n = len(entry.labels)
    grid = J * n * 4
    if rung in ("jitter", "masked"):
        return jitter_bound_bytes(rung, ex.function or "last", block, n, J, entry.is_counter,
                                  entry.is_delta) + grid
    if rung == "mxu":
        wm = MK.window_matrices(block, ex.start_ms - block.base_ms, ex.step_ms, pad_steps(J),
                                ex.window_ms)
        return regular_bound_bytes(wm, n, J, 0, "rate") + grid
    if rung == "general":
        return general_bound(entry, ex, 0)["bound_bytes"] + grid
    return int(block.lens.sum()) * 12 + n * 12 + grid  # ts, vals, raw per sample; lens, gid


def topk_sets_equal(got, want, what: str) -> None:
    """Per step the same series indices with bit-equal values (the order
    inside the k slots is free)."""
    import torch

    (gv, gi), (wv, wi) = got, want
    require(gv.shape == wv.shape, f"{what}: shape {tuple(gv.shape)} != {tuple(wv.shape)}")
    go, wo = torch.argsort(gi, dim=0), torch.argsort(wi, dim=0)
    require(torch.equal(torch.gather(gi, 0, go), torch.gather(wi, 0, wo)),
            f"{what}: the winner sets differ")
    require(torch.equal(torch.gather(gv, 0, go).view(torch.int32),
                        torch.gather(wv, 0, wo).view(torch.int32)),
            f"{what}: the winners' values differ")


def quantiles_equal(got, want, grid, members, q: float, what: str) -> int:
    """NaN masks equal; selected order statistics (a whole rank) bit-equal;
    interpolated ones within 2 ulp. Returns how many differ at all."""
    import torch

    require(torch.equal(torch.isnan(got), torch.isnan(want)), f"{what}: NaN masks differ")
    G = members.num_groups
    sizes = members.starts[1:].long() - members.starts[:-1].long()
    gm = torch.repeat_interleave(torch.arange(G, device=grid.device), sizes)
    present = (~torch.isnan(grid[:, members.perm.long()])).T.to(torch.float32)
    count = torch.zeros((G, grid.shape[0]), device=grid.device).index_add_(0, gm, present)
    rank = float(np.float32(min(max(q, 0.0), 1.0))) * torch.clamp(count - 1.0, min=0.0)
    whole = (rank == torch.floor(rank)) & ~torch.isnan(want)
    require(torch.equal(got[whole].view(torch.int32), want[whole].view(torch.int32)),
            f"{what}: a selected order statistic differs")
    m = ~torch.isnan(want) & torch.isfinite(want)
    ulps = (got[m].view(torch.int32).long() - want[m].view(torch.int32).long()).abs()
    require(not bool((ulps > 2).any()), f"{what}: an interpolated quantile is off by more "
            f"than 2 ulp")
    return int((ulps > 0).sum())


def winners_match(got_labels, got, want_labels, want, bottom: bool, rtol: float,
                  what: str) -> int:
    """Presented topk rows against the plain path's: the series both chose
    agree in value; per step the winning values, sorted, agree; a series
    only one side chose at a step lies within rtol of the other side's
    boundary value (a near tie). Returns the near ties."""
    keys = {}
    for labels in (got_labels, want_labels):
        for l in labels:
            keys.setdefault(tuple(sorted(l.items())), len(keys))
    require(len({tuple(sorted(l.items())) for l in got_labels}) == len(got_labels),
            f"{what}: a series presented twice")

    def aligned(labels, vals):
        out = np.full((len(keys), want.shape[1]), np.nan, np.float32)
        out[[keys[tuple(sorted(l.items()))] for l in labels]] = vals
        return out

    g, w = aligned(got_labels, got), aligned(want_labels, want)
    gh, wh = ~np.isnan(g), ~np.isnan(w)
    require(np.allclose(g[gh & wh], w[gh & wh], rtol=rtol), f"{what}: a winner's values differ")
    count = gh.sum(axis=0)
    require(np.array_equal(count, wh.sum(axis=0)), f"{what}: winner counts differ")
    gs, ws = np.sort(g, axis=0), np.sort(w, axis=0)  # NaN last
    ranked = np.arange(len(keys))[:, None] < count[None, :]
    require(np.allclose(gs[ranked], ws[ranked], rtol=rtol), f"{what}: winning values differ")
    cols = np.arange(want.shape[1])
    last = np.maximum(count - 1, 0)
    g_edge = gs[last, cols] if bottom else gs[0]  # the worst winner of each step
    w_edge = ws[last, cols] if bottom else ws[0]
    only_g, only_w = gh & ~wh, wh & ~gh
    require(np.allclose(g[only_g], w_edge[np.nonzero(only_g)[1]], rtol=rtol)
            and np.allclose(w[only_w], g_edge[np.nonzero(only_w)[1]], rtol=rtol),
            f"{what}: a step chose a series away from the boundary")
    return int(only_g.sum())


def run_epilogue_query(engine, q: str, rung: str, grid: str, card: str) -> dict:
    """One phase-9 query: cold-or-hit then warm through the user's entry
    point (the rung in its store mode and one order-statistics launch);
    the store grid, the order statistic and the presented rows against
    their plain versions; the launches timed."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import order_stats as OS
    from filodb_tpu_torch.ops.kernels import pad_steps

    runs = []
    for attempt in ("first", "second"):
        res, vals, wall = run_main(engine, q, grid, rung, epilogue=True)
        st = res.stats
        outcome = ("build" if st.cache_misses else "extend" if st.cache_extends
                   else "hit" if st.cache_hits else "none")
        if attempt == "second":
            require(outcome == "hit" and st.bytes_staged == 0,
                    f"{q}: the warm run must be a hit with no staging, stats {st}")
        runs.append((res, vals, wall, outcome))
    ex = exec_node(engine, q)
    entry = ex.superblock(engine.context())
    block, J, func = entry.block, ex.num_steps(), ex.function or "last"
    params = epilogue_params(ex)
    j_pad, s_pad = pad_steps(J), block.vals.shape[0]
    flags = {"is_counter": entry.is_counter, "is_delta": entry.is_delta}
    grid_k = AGG.fused_range_series(func, block, params, **flags)
    grid_p = series_plain(entry, ex, rung)
    store_err = compare(grid_k[:J], grid_p[:J], f"{q}: store grid vs plain", rtol=1e-3)
    # the order statistics run over the real steps, as fused_topk/fused_quantile call them
    n_real, grid_k, grid_p = block.n_series, grid_k[:J], grid_p[:J]
    strip = ex.function is not None and ex.function not in ("last_over_time", "timestamp")
    res, vals = runs[0][0], runs[0][1]
    out = {"rung": rung, "first_run": runs[0][3], "first_ms": runs[0][2] * 1e3,
           "warm_ms": runs[1][2] * 1e3, "store_max_abs_err": store_err,
           "rows": len(res.grids[0].labels)}
    if ex.op in ("topk", "bottomk"):
        k, bottom = min(max(int(ex.params[0]), 1), s_pad), ex.op == "bottomk"
        kname = "topk_steps"
        got_k = OS.topk_steps(grid_k, k, bottom, n_real=n_real)
        topk_sets_equal(got_k, OS.topk_steps_plain(grid_k, k, bottom), f"{q}: kernel vs plain")
        out["max_abs_err"] = 0.0  # the sets and their values are bit-equal
        wv, wi = OS.topk_steps_plain(grid_p, k, bottom)
        want = ex._present_topk(wv.cpu().numpy(), wi.cpu().numpy(), entry.labels, strip,
                                J).grids[0]
        out["near_ties"] = winners_match(res.grids[0].labels, vals, want.labels,
                                         want.values_np(), bottom, 1e-3, q)
        require(len(res.grids[0].labels) <= k * J and np.isfinite(vals).any(),
                f"{q}: {len(res.grids[0].labels)} rows")
        kernel = lambda: OS.topk_steps(grid_k, k, bottom, n_real=n_real)  # noqa: E731
        plain = lambda: OS.topk_steps_plain(grid_k, k, bottom)  # noqa: E731
        library = lambda: torch.topk(grid_k[:, :n_real], k, dim=1)  # noqa: E731
        library_call = f"torch.topk([J, n_real] of the grid, {k}, dim=1)"
        out_bytes, G = k * J * 8, 1
    else:
        qv, kname = float(ex.params[0]), "segment_quantile"
        members, G, labels = AGG.group_members_memo(block, entry.labels, ex.by, ex.without,
                                                    strip_metric=strip)
        got_q = OS.segment_quantile(grid_k, members, qv)
        want_q = OS.segment_quantile_plain(grid_k, members, qv)
        out["interpolated_differing"] = quantiles_equal(got_q, want_q, grid_k, members, qv,
                                                        f"{q}: kernel vs plain")
        m = ~torch.isnan(want_q)
        out["max_abs_err"] = float((got_q[m].double() - want_q[m].double()).abs().max())
        want = OS.segment_quantile_plain(grid_p, members, qv)
        out["end_to_end_max_abs_err"] = compare(torch.as_tensor(vals, device=grid_k.device),
                                                want, f"{q}: end to end vs plain", rtol=1e-3)
        require(labels == res.grids[0].labels and len(labels) == G, f"{q}: group labels")
        kernel = lambda: OS.segment_quantile(grid_k, members, qv)  # noqa: E731
        plain = lambda: OS.segment_quantile_plain(grid_k, members, qv)  # noqa: E731
        library, library_call = None, "none: no torch call computes a grouped quantile"
        if G == 1:
            library = lambda: torch.nanquantile(grid_k[:, :n_real], qv, dim=1)  # noqa: E731
            library_call = f"torch.nanquantile([J, n_real] of the grid, {qv}, dim=1)"
        # the output, and the member lists read once: perm, starts, large, small
        out_bytes = G * J * 4 + members.perm.numel() * 4 + (G + 1) * 4 + G * 4
    plan = OS.LAST_PLAN
    out.update({"order_route": plan.route, "cluster": plan.cluster})
    buf = GA.series_buffer(s_pad, j_pad, J, block.vals.device)
    acc, cnt = GA.accumulators("sum", 1, j_pad, block.vals.device)
    store = store_launch(entry, ex, rung, GA.STORE, buf, buf)
    agg = store_launch(entry, ex, rung, "sum", acc, cnt)
    gpu_sample(f"phase9 {q!r} before")
    out.update({
        "kernel": kname, "groups": G, "order_plan": str(plan),
        "kernel_ms": cuda_ms(kernel, reps=20), "kernel_ms_back_to_back": back_to_back_ms(kernel),
        "store_ms": cuda_ms(store, reps=20), "store_ms_back_to_back": back_to_back_ms(store),
        "aggregate_ms_back_to_back": back_to_back_ms(agg),
        "plain_ms": cuda_ms(plain, reps=3, warmup=1),
        "library_ms": cuda_ms(library, reps=20) if library else None,
        "library_call": library_call,
    })
    gpu_sample(f"phase9 {q!r} after")
    grid_bytes = J * n_real * 4  # the real series at the real steps, read once
    out["bound_bytes"] = grid_bytes + out_bytes
    out["bound_ms"] = out["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    out["store_bound_bytes"] = store_bound_bytes(entry, ex, rung)
    out["store_bound_ms"] = out["store_bound_bytes"] / HBM_BYTES_PER_S * 1e3
    lib = (f"{out['library_ms']:.4f} ms ({library_call})" if library else library_call)
    print(f"phase9 query {q!r}: rung {rung} in store mode + {kname}; first run "
          f"({out['first_run']}) {out['first_ms']:.1f} ms, warm (hit) {out['warm_ms']:.1f} ms "
          f"end to end, 2 launches each; {out['rows']} rows x {J} steps; store grid "
          f"[{j_pad}, {s_pad}] matches the plain rung (max_abs_err {store_err:.3g}, rtol 1e-3); "
          f"{kname} equals its plain version on the same grid and the presented result the "
          f"plain path's; {kname} route {plan.route}, cluster {plan.cluster} x {plan.threads} "
          f"threads: {out['kernel_ms']:.4f} ms (median of 20; "
          f"{out['kernel_ms_back_to_back']:.4f} back to back; {plan}), bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_bytes']} bytes), plain {out['plain_ms']:.3f} "
          f"ms, library {lib}; store launch {out['store_ms']:.4f} ms "
          f"({out['store_ms_back_to_back']:.4f} back to back; the sum aggregate of one group "
          f"{out['aggregate_ms_back_to_back']:.4f}), store bound {out['store_bound_ms']:.4f} ms "
          f"({out['store_bound_bytes']} bytes) on {card}")
    return out


def order_grid_on_card(n_real: int, S: int, J: int, seed: int, device):
    """A store-mode grid drawn on the card: [J, S] f32, per step ``n_real``
    rate-like values (0-10 per second to three decimals, so about ten
    series share each value at 100k) with 2 % NaN, the padded rows NaN."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    grid = torch.full((J, S), float("nan"), dtype=torch.float32, device=device)
    v = torch.round(torch.rand((J, n_real), generator=g, device=device) * 10_000) / 1000
    absent = torch.rand((J, n_real), generator=g, device=device) < 0.02
    grid[:, :n_real] = torch.where(absent, float("nan"), v)
    return grid


STREAM_SERIES = 1 << 20  # phase 9b: past MAX_CLUSTER x MAX_SLICE keys


def phase_order_stream(seed: int, device, card: str) -> dict:
    """Phase 9b: both order-statistics kernels on the streaming route (a
    column past the cluster's shared memory), against plain and timed."""
    import torch

    from filodb_tpu_torch.ops import order_stats as OS

    n, J = STREAM_SERIES, int((END_S - START_S) // STEP_S) + 1
    grid = order_grid_on_card(n, n, J, seed, device)
    members = OS.segment_members(torch.zeros(n, dtype=torch.int64, device=device), 1)
    out = {}
    for kname, kernel, plain, extra in (
            ("topk_steps", lambda: OS.topk_steps(grid, 5, n_real=n),
             lambda: OS.topk_steps_plain(grid, 5), 5 * J * 8),
            ("segment_quantile", lambda: OS.segment_quantile(grid, members, 0.99),
             lambda: OS.segment_quantile_plain(grid, members, 0.99), J * 4 + n * 4 + 12)):
        got, want = kernel(), plain()
        plan = OS.LAST_PLAN
        require(plan.route == "stream" and plan.cluster == OS.MAX_CLUSTER,
                f"9b {kname}: route {plan.route}, cluster {plan.cluster}")
        if kname == "topk_steps":
            topk_sets_equal(got, want, "9b topk_steps kernel vs plain")
            err = 0.0  # the sets and their values are bit-equal
        else:
            quantiles_equal(got, want, grid, members, 0.99, "9b segment_quantile vs plain")
            m = ~torch.isnan(want)
            err = float((got[m].double() - want[m].double()).abs().max())
        gpu_sample(f"phase9b {kname} before")
        row = {"order_route": plan.route, "cluster": plan.cluster, "threads": plan.threads,
               "max_abs_err": err, "ms": cuda_ms(kernel, reps=20),
               "ms_back_to_back": back_to_back_ms(kernel, reps=20),
               "plain_ms": cuda_ms(plain, reps=3, warmup=1),
               "bound_bytes": J * n * 4 + extra}
        gpu_sample(f"phase9b {kname} after")
        row["bound_ms"] = row["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"phase9b {kname} on {J} x {n} card-drawn series ({J * n * 4 / 1e6:.0f} MB): route "
              f"{plan.route}, cluster {plan.cluster} x {plan.threads} threads; equals its plain "
              f"version; {row['ms']:.4f} ms (median of 20; {row['ms_back_to_back']:.4f} back to "
              f"back), bound {row['bound_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms on {card}")
        out[kname] = row
    return out


def phase_epilogues(engine, card: str, queries, grid: str) -> dict:
    """Phase 9 on one store: each epilogue query (``run_epilogue_query``)."""
    return {q: run_epilogue_query(engine, q, rung, grid, card) for q, rung in queries}


def epilogue_rows(per_query: dict, store_rows: dict, stream: dict) -> list:
    """The kernels line's rows of the two order-statistics kernels (their
    numbers from the first query of each, and phase 9b's streaming route),
    and the store mode's numbers added to the rung rows in ``store_rows``
    (rung -> row)."""
    rows = []
    for name, replaces in ORDER_KERNELS.items():
        mine = {q: v for q, v in per_query.items() if v["kernel"] == name}
        first = next(iter(mine.values()))
        rows.append({
            "name": name, "route": "cuda", "source": "filodb_tpu_torch/csrc/order_stats.cu",
            "replaces": replaces, "launches": 2 * len(mine),
            "max_abs_err": max(v["max_abs_err"] for v in mine.values()),
            "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": first["library_ms"], "library_call": first["library_call"],
            "ms_back_to_back": first["kernel_ms_back_to_back"],
            "ms_is": next(iter(mine)) + ", phase 9", "order_route": first["order_route"],
            "cluster": first["cluster"], "queries": mine, "stream_route_phase9b": stream[name],
        })
    for rung, row in store_rows.items():
        mine = {q: v for q, v in per_query.items() if v["rung"] == rung}
        first = next(iter(mine.values()))
        row["launches"] += 2 * len(mine)
        row["store_launches"] = 2 * len(mine)
        row.update({"store_ms": first["store_ms"],
                    "store_ms_back_to_back": first["store_ms_back_to_back"],
                    "store_aggregate_ms_back_to_back": first["aggregate_ms_back_to_back"],
                    "store_bound_ms": first["store_bound_ms"],
                    "store_ms_is": next(iter(mine)) + ", phase 9"})
    return rows


HIST_QUERY = "histogram_quantile(0.99, sum by (le) (rate(http_request_latency_bucket[5m])))"
HIST_SUM_QUERY = "sum by (le) (rate(http_request_latency_bucket[5m]))"
N_BUCKETS = 12  # bench.py's PROM_DEFAULT scheme (11 finite bounds + Inf)
HIST_LES = np.array([0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, np.inf])
HIST_SEED = 42  # bench.py's build_memstore_hist
# 7c's store: bench.py's histograms on irregular scrapes, cut to half the
# series so that the whole run stays within half its time limit (building a
# 100k-series histogram store takes the host about 100 s)
HIST_IRREGULAR_SERIES = 25_000


def hist_tags(i: int) -> dict:
    """bench.py's tags of histogram series ``i`` (its ``build_memstore_hist``)
    and a ``zone`` of eight, which phase 12's ``sum by (zone)`` groups by."""
    from filodb_tpu_torch.core.schemas import METRIC_TAG

    return {METRIC_TAG: "http_request_latency", "_ws_": "demo", "_ns_": "App-2",
            "instance": f"host-{i}", "zone": f"z{i % 8}"}


def build_memstore_hist(n_series: int, grid: str):
    """bench.py's ``build_memstore_hist`` through the port's shard API:
    ``n_series`` native histograms (PROM_DEFAULT, 12 buckets) on 8 shards,
    720 samples each, drawn per block of 2000 series from seed 42 as
    bench.py draws them; ``regular`` is bench.py's store (every 10 s from
    BASE), ``irregular`` moves every series onto its own 5-15 s intervals
    (drawn from a second stream, so the bucket counts stay bench.py's),
    ``jitter`` onto bench.py's ``fused_jitter`` timestamps (``build_memstore``
    with jitter 0.05 and phase 5 s: the 10 s grid shifted by 5 s, each
    sample moved by a rounded uniform +-5 % of the interval, drawn from a
    third stream)."""
    return build_memstore_hists(n_series, (grid,))[grid]


def build_memstore_hists(n_series: int, grids) -> dict:
    """``build_memstore_hist``'s stores of several ``grids`` from one draw:
    each block of 2000 series' bucket counts is drawn once and ingested
    into every store with its grid's timestamps (phase 7b's regular store
    and phase 16's jittered one). Returns grid -> memstore."""
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    rng = np.random.default_rng(HIST_SEED)
    gaps = np.random.default_rng(HIST_SEED + 1)
    jit = np.random.default_rng(HIST_SEED + 2)
    ts = BASE + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
    nominal = ts + JITTER_PHASE_MS
    stores = {}
    for grid in grids:
        stores[grid] = TimeSeriesMemStore(StoreConfig(max_chunk_size=N_SAMPLES))
        stores[grid].setup(Dataset("prometheus"), range(N_SHARDS))
    blk = 2_000

    def draw(b0):
        n = min(blk, n_series - b0)
        incr = rng.poisson(2.0, size=(n, N_SAMPLES, N_BUCKETS)).astype(np.float64)
        incr[..., -1] = incr.sum(-1)  # +Inf bucket grows with everything
        hist = np.cumsum(np.cumsum(incr, axis=2), axis=1)
        total = np.cumsum(rng.uniform(0, 5, size=(n, N_SAMPLES)), axis=1)
        rows = {"regular": np.broadcast_to(ts, (n, N_SAMPLES))}
        if "irregular" in grids:
            rows["irregular"] = BASE + np.cumsum(gaps.integers(5_000, 15_001, (n, N_SAMPLES)),
                                                 axis=1)
        if "jitter" in grids:
            rows["jitter"] = nominal + np.rint(
                jit.uniform(-0.05, 0.05, (n, N_SAMPLES)) * 10_000).astype(np.int64)
        return hist, total, rows

    # the draws of the next block run on a helper thread (numpy's generators
    # release the GIL) while this one ingests the current block; one thread
    # draws in block order, so the stores are those of sequential draws
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(draw, 0) if n_series > 0 else None
        for b0 in range(0, n_series, blk):
            hist, total, rows = pending.result()
            pending = pool.submit(draw, b0 + blk) if b0 + blk < n_series else None
            count = hist[..., -1]
            for i in range(len(hist)):
                tags = hist_tags(b0 + i)
                shard_num = shard_for(tags, spread=SPREAD, num_shards=N_SHARDS)
                for grid, ms in stores.items():
                    ms.shard("prometheus", shard_num).ingest_series(SeriesBatch(
                        PROM_HISTOGRAM, tags, rows[grid][i],
                        {"sum": total[i], "count": count[i], "h": hist[i]},
                        bucket_les=HIST_LES))
    return stores


def whole_series(part, col: str):
    """(timestamps, values) of every sample of a partition: its one sealed
    chunk's arrays as they are (the stores here seal each series in one
    chunk of ``N_SAMPLES``), else ``samples_in_range``."""
    if len(part.chunks) == 1 and part.num_samples() == part.chunks[0].n:
        arrays = part.chunks[0].arrays
        return arrays["timestamp"], arrays[col]
    return part.samples_in_range(-(2**62), 2**62, col)


def cpu_baseline_hist(ms) -> np.ndarray:
    """bench.py's ``cpu_baseline_hist`` oracle (f64 numpy: per-bucket
    extrapolated rate over the shared grid -> bucket-wise sum across series
    -> histogram_quantile(0.99) with the +Inf top-bucket rule) on the port's
    store: [J]."""
    Q = 0.99
    les = HIST_LES
    num_steps = int((END_S - START_S) // STEP_S) + 1
    out_t = np.int64(START_S * 1000) + np.arange(num_steps, dtype=np.int64) * int(STEP_S * 1000)
    t0g = BASE + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
    hi1 = np.searchsorted(t0g, out_t, side="right")
    lo1 = np.searchsorted(t0g, out_t - WINDOW_MS, side="right")
    cnt = hi1 - lo1
    T = len(t0g)
    lo_c = np.minimum(lo1, T - 1)
    hi_c = np.minimum(hi1 - 1, T - 1)
    tf = t0g[lo_c].astype(np.float64) / 1e3
    tl = t0g[hi_c].astype(np.float64) / 1e3
    sampled = tl - tf
    dur_start = tf - (out_t / 1e3 - WINDOW_MS / 1e3)
    dur_end = out_t / 1e3 - tl
    avg_dur = sampled / np.maximum(cnt - 1, 1)
    thresh = avg_dur * 1.1
    ds = np.where(dur_start >= thresh, avg_dur / 2, dur_start)
    de = np.where(dur_end >= thresh, avg_dur / 2, dur_end)
    factor = np.where(cnt >= 2, (sampled + ds + de) / np.maximum(sampled, 1e-30), np.nan)
    parts = [p for s in ms.shard_nums("prometheus")
             for p in ms.shard("prometheus", s).partitions.values()]
    bucket_sum = np.zeros((num_steps, len(les)), dtype=np.float64)
    blk = 4_000
    for b0 in range(0, len(parts), blk):
        H = np.stack([whole_series(parts[i], "h")[1]
                      for i in range(b0, min(b0 + blk, len(parts)))])
        dlt = H[:, hi_c] - H[:, lo_c]
        bucket_sum += np.nansum(dlt * factor[None, :, None] / (WINDOW_MS / 1e3), axis=0)
    return quantile_of_bucket_sums(bucket_sum, Q)


def quantile_of_bucket_sums(bucket_sum: np.ndarray, Q: float) -> np.ndarray:
    """bench.py's f64 histogram_quantile of [J, B] summed cumulative
    buckets over ``HIST_LES`` (the +Inf top-bucket rule): [J]."""
    les = HIST_LES
    total = bucket_sum[:, -1]
    rank = Q * total
    meets = bucket_sum >= rank[:, None]
    idx = np.argmax(meets, axis=1)
    idx = np.where(meets.any(1), idx, len(les) - 1)
    c_hi = np.take_along_axis(bucket_sum, idx[:, None], axis=1)[:, 0]
    c_lo = np.where(idx > 0, np.take_along_axis(bucket_sum, np.maximum(idx - 1, 0)[:, None],
                                                axis=1)[:, 0], 0.0)
    le_hi = les[idx]
    le_lo = np.where(idx > 0, les[np.maximum(idx - 1, 0)], 0.0 if les[0] > 0 else -np.inf)
    frac = (rank - c_lo) / np.maximum(c_hi - c_lo, 1e-30)
    val = le_lo + (le_hi - le_lo) * frac
    val = np.where(idx == len(les) - 1, les[-2], val)
    return np.where((total > 0) & np.isfinite(total), val, np.nan)


def hist_block_on_card(grid: str, n_real: int, m: int, rng, device):
    """Seeded cumulative histograms (12 buckets) staged by the port, on the
    card, for the kernels-vs-plain phase: ``regular`` or ``irregular``
    (5-15 s, ragged, one empty series); NaN bucket counts in series 3."""
    from filodb_tpu_torch.ops.staging import stage_histogram_series

    series = []
    for i in range(n_real):
        k = m if grid == "regular" else int(rng.integers(m // 2, m + 1)) * (i != n_real // 2)
        ts = (BASE + 3_000 + np.arange(k, dtype=np.int64) * 10_000 if grid == "regular"
              else BASE + np.cumsum(rng.integers(5_000, 15_001, k)).astype(np.int64))
        incr = rng.poisson(2.0, size=(k, N_BUCKETS)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        h = np.cumsum(np.cumsum(incr, axis=1), axis=0)
        if i == 3 and k > 40:
            h[20:24, 2] = np.nan
        series.append((ts, h))
    block = stage_histogram_series(series, BASE, N_BUCKETS, [(0, i) for i in range(n_real)])
    require(block.vals.shape[0] > n_real, "padded rows expected")
    return block.to_device(device)


def phase_hist_vs_plain(seed: int, device) -> tuple[float, float]:
    """7a: the histogram kernel against its plain versions on seeded blocks.
    Partials: every function of FUSED_HIST_FUNCS, is_delta both ways,
    shared and per-series bounds, G = 1 and 8 (shared-memory partials, in
    slices of whole steps at G = 8) and G = the real rows (global atomics,
    each row its own group: bit-equal, max_abs_err 0 is required), padded
    rows, blocks of 300 and 3000 real rows; elsewhere rtol 1e-3 (atomics
    and run sums reorder a group's f32 sums). The folded quantile at q in
    {-0.1, 0, 0.5, 0.99, 1, 1.1} against hist_quantile_plain on the same
    launch's partials, with a zero-total group, a group with no member, a
    bucket without a member (the NaN counts of series 3, alone in its
    group), and first bounds 0.005, 0 and -1. NaN masks equal. Returns the
    largest absolute differences (range, quantile)."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

    rng = np.random.default_rng(seed + 5)
    params = RangeParams(BASE - 120_000, 60_000, 80, WINDOW_MS)
    j_pad = pad_steps(params.num_steps)
    worst_range = 0.0
    for grid, n_real in (("regular", 300), ("irregular", 300), ("regular", 3000),
                         ("irregular", 3000)):
        block = hist_block_on_card(grid, n_real, 400, rng, device)
        n, S = block.n_series, block.vals.shape[0]
        windows = (AGG._hist_shared_windows(block, params, j_pad) if grid == "regular"
                   else None)
        for G in (1, 8, n):
            gids = torch.full((S,), G, dtype=torch.int64, device=device)
            gids[:n] = torch.arange(n, device=device) % G
            want_plan = HK.hist_plan(block.vals.shape[1], params.num_steps, N_BUCKETS, G,
                                     windows is not None)
            for func in sorted(HK.FUSED_HIST_FUNCS):
                for is_delta in (False, True):
                    acc, cnt = HK.hist_range_partials(func, block, gids, G, params, windows,
                                                      is_delta)
                    require(HK.LAST_PLAN == want_plan, f"7a plan {HK.LAST_PLAN}")
                    pa, pc = HK.hist_partials_plain(func, block, gids, G, params, windows,
                                                    is_delta)
                    # the trash group's row is dropped (the plain version's
                    # index_add reaches it with padded rows, the kernel never)
                    require(torch.equal(cnt[:G], pc[:G]),
                            f"7a {grid} {func} G={G}: member counts differ")
                    got = GA.finish_groups("sum", acc, cnt, G)
                    want = GA.finish_groups("sum", pa, pc, G)
                    what = f"7a {grid} sum({func}) delta={is_delta} G={G}"
                    if G == n:
                        err = compare(got, want, what, rtol=0.0)
                        require(err == 0.0, f"{what}: not bit-equal (max_abs_err {err})")
                    else:
                        err = compare(got, want, what, rtol=1e-3)
                    worst_range = max(worst_range, err)
            plan, grid_dims = HK.LAST_PLAN, HK.LAST_GRID
            print(f"phase7a {grid} block {list(block.vals.shape)} ({n} real rows) G={G}: "
                  f"hist_range matches plain for {len(HK.FUSED_HIST_FUNCS)} functions x "
                  f"is_delta ({plan.partials} partials, {plan.rows} rows per tile, "
                  f"{plan.slices} slice(s) of {plan.steps} steps, float{plan.vec} fetches, "
                  f"ts {'staged' if plan.staged else 'in place'}; grid {grid_dims})")
    worst_q = 0.0
    G = 6
    for first_le in (0.005, 0.0, -1.0):
        block = hist_block_on_card("irregular", 300, 400, rng, device)
        n, S = block.n_series, block.vals.shape[0]
        gids = torch.full((S,), G, dtype=torch.int64, device=device)
        gids[:n] = 4 + torch.arange(n, device=device) % 2
        gids[3] = 3  # NaN bucket counts alone: buckets without a member
        gids[7:n:50] = 1
        block.vals[7:n:50] = 0.0  # zero totals; groups 0 and 2 have no member
        les = HIST_LES.copy()
        les[0] = first_le
        les_t = torch.tensor(les, dtype=torch.float32, device=device)
        for q in (-0.1, 0.0, 0.5, 0.99, 1.0, 1.1):
            got, acc, cnt = HK.hist_range_quantile(q, "rate", block, gids, G, params, les_t)
            want = HK.hist_quantile_plain(q, acc, cnt, G, les_t, params.num_steps)
            require(torch.equal(torch.isinf(got), torch.isinf(want)),
                    f"7a quantile q={q}: infinities differ")
            fin = torch.isfinite(want)
            worst_q = max(worst_q, compare(got[fin], want[fin], f"7a quantile q={q}",
                                           rtol=1e-3))
            require(torch.equal(torch.isnan(got), torch.isnan(want)),
                    f"7a quantile q={q}: NaN masks differ")
    print(f"phase7a hist_range matches plain (max_abs_err {worst_range:.3g}; bit-equal at "
          f"G = S); the folded quantile matches hist_quantile_plain on its launch's partials "
          f"at q in -0.1, 0, 0.5, 0.99, 1, 1.1, les[0] in 0.005, 0, -1 "
          f"(max_abs_err {worst_q:.3g})")
    return worst_range, worst_q


def run_hist(engine, q: str, want_class: str, want_variant: str, end_s: float = END_S,
             folds: int = 1):
    """One histogram query through the user's entry point, every launch
    count and the folded-quantile count set to 0 just before and read just
    after: it must take ``want_variant`` on a ``want_class`` grid, launch
    the histogram range kernel exactly once and no other kernel, and carry
    ``folds`` quantiles folded into that launch. Returns the result, its
    [G, J] on the host, the end-to-end seconds and the counts read after it
    (``hist_quantile``: the folded quantiles)."""
    import importlib

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.staging import grid_class

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in KERNEL_COUNTERS.items()}
    seen = []
    ladder = AGG.hist_variant

    def watched(block, *args):
        variant = ladder(block, *args)
        seen.append((grid_class(block), variant))
        return variant

    AGG.hist_variant = watched
    try:
        for name, (_, attr) in KERNEL_COUNTERS.items():
            setattr(mods[name], attr, 0)
        HK.FOLDED_QUANTILES = HK.JITTER_LAUNCHES = 0
        t0 = time.perf_counter()
        res = engine.query_range(q, START_S, end_s, STEP_S)
        vals = res.grids[0].values_np()
        wall = time.perf_counter() - t0
        counts = {name: getattr(mods[name], attr) for name, (_, attr) in KERNEL_COUNTERS.items()}
        counts["hist_quantile"] = HK.FOLDED_QUANTILES
        counts["hist_jitter"] = HK.JITTER_LAUNCHES
    finally:
        AGG.hist_variant = ladder
    require(seen == [(want_class, want_variant)],
            f"{q}: grid class and variant {seen}, expected {[(want_class, want_variant)]}")
    want = {k: int(k == "hist_range") for k in KERNEL_COUNTERS}
    want["hist_quantile"] = folds
    want["hist_jitter"] = int(want_variant == "hist_jitter")  # of the hist_range launches
    require(counts == want, f"{q}: launches {counts}, expected {want}")
    return res, vals, wall, counts


# the kernels JSON line's histogram rows: the range kernel's launches, the
# quantiles folded into them and the launches in the jitter mode
HIST_KERNELS = ("hist_range", "hist_quantile", "hist_jitter")


def add_launches(total: dict, counts: dict) -> dict:
    """``total`` with each histogram row's count in ``counts`` added."""
    return {k: total.get(k, 0) + counts[k] for k in HIST_KERNELS}


def hist_plain(entry, ex, q: float):
    """The canonical query's plain path on a superblock: the range kernel's
    and the quantile's plain versions, [G, J]."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import pad_steps

    gids, G, params = path_args(entry, ex)
    windows = (AGG._hist_shared_windows(entry.block, params, pad_steps(params.num_steps))
               if entry.block.regular_ts is not None else None)
    jitter = (AGG._hist_jitter_windows(entry.block, params)
              if AGG.hist_variant(entry.block, params) == "hist_jitter" else None)
    acc, cnt = HK.hist_partials_plain(ex.function, entry.block, gids, G, params, windows,
                                      jitter=jitter)
    return HK.hist_quantile_plain(q, acc, cnt, G, entry.les_dev, params.num_steps)[:, : ex.num_steps()]


def check_hist_partials(entry, ex, phase: str) -> tuple[float, float]:
    """The kernel against its plain versions on the query's superblock, at
    the main path's shape and layout, one launch per q in {0.25, 0.5, 0.9,
    0.99} with the quantile folded in. Each launch's ``(acc, cnt)``: member
    counts equal to plain, the finished [G, J, B] group sums within rtol
    1e-3 (atomics and run sums reorder the f32 sums) with equal NaN masks;
    its quantiles equal hist_quantile_plain on those partials (rtol 1e-3,
    NaN and infinity masks equal). bench.py's +Inf bucket is twice bucket
    10, so q = 0.99 always lands in the top bucket and returns its lower
    bound; a lower q interpolates inside the buckets. Returns the largest
    absolute differences (range, quantile)."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import pad_steps

    block = entry.block
    gids, G, params = path_args(entry, ex)
    J, B = ex.num_steps(), block.vals.shape[2]
    windows = (AGG._hist_shared_windows(block, params, pad_steps(J))
               if block.regular_ts is not None else None)
    pa, pc = HK.hist_partials_plain(ex.function, block, gids, G, params, windows)
    want = GA.finish_groups("sum", pa, pc, G).reshape(G, -1, B)[:, :J]
    range_err = q_err = 0.0
    for q in (0.25, 0.5, 0.9, 0.99):
        out, acc, cnt = HK.hist_range_quantile(q, ex.function, block, gids, G, params,
                                               entry.les_dev, windows)
        require(torch.equal(cnt[:G], pc[:G]),
                f"{phase}: hist_range member counts differ from plain")
        got = GA.finish_groups("sum", acc, cnt, G).reshape(G, -1, B)[:, :J]
        range_err = max(range_err, compare(got, want, f"{phase}: hist_range [G, J, B] vs plain",
                                           rtol=1e-3))
        qwant = HK.hist_quantile_plain(q, acc, cnt, G, entry.les_dev, J)
        require(torch.equal(torch.isinf(out), torch.isinf(qwant)),
                f"{phase}: folded quantile q={q}: infinities differ")
        q_err = max(q_err, compare(out[:, :J], qwant[:, :J],
                                   f"{phase}: folded quantile q={q}", rtol=1e-3))
        del out, acc, cnt, got
    plan, grid_dims = HK.LAST_PLAN, HK.LAST_GRID
    print(f"{phase}: at the main path's shape ({list(block.vals.shape)}, {plan.partials} "
          f"partials, {plan.rows} rows per tile, {plan.slices} slice(s), float{plan.vec} "
          f"fetches, ts {'staged' if plan.staged else 'in place'}, grid {grid_dims}, "
          f"{plan.smem_bytes} bytes of shared memory) hist_range's [G, J, B] matches plain "
          f"(max_abs_err {range_err:.3g}; member counts equal) and the folded quantile on "
          f"its launch's partials matches plain at q in 0.25, 0.5, 0.9, 0.99 "
          f"(max_abs_err {q_err:.3g})")
    return range_err, q_err


def sampled_positions(block, params, windows, r0: int, r1: int):
    """The distinct sample positions the rate family reads in rows [r0, r1):
    each window's first and last sample where it holds two or more, as a
    sorted [rows, 2J] tensor with -1 for none."""
    import torch

    J = params.num_steps
    if windows is not None:
        lo, hi = windows[0][:J].long(), windows[1][:J].long()
        lo, hi = lo[None].expand(r1 - r0, J), hi[None].expand(r1 - r0, J)
    else:
        start_off = params.start_ms - block.base_ms
        out_t = (start_off + torch.arange(J, device=block.ts.device)
                 * params.step_ms).to(torch.int32)
        ts = block.ts[r0:r1]
        q_hi = out_t[None, :].expand(r1 - r0, J).contiguous()
        hi = torch.searchsorted(ts, q_hi, right=True)
        lo = torch.searchsorted(ts, (q_hi - params.window_ms).to(torch.int32), right=True)
    ok = hi - lo >= 2
    pos = torch.cat([torch.where(ok, lo, -1), torch.where(ok, hi - 1, -1)], dim=1)
    return torch.sort(pos, dim=1).values


def hist_bound_bytes(block, params, G: int, windows):
    """Bytes the range kernel's function must move over the real rows and
    steps: each real row's buckets at the distinct first and last samples
    of its windows with two samples or more (``sample_bytes``), plus, on
    per-series bounds, each real row's timestamps (the window search); each
    row's gid (and length), the [J] bounds, and acc/cnt written once. Also
    the sector floor: the bytes of the 32-byte sectors those samples touch
    (a 48-byte sample spans two), with the same other terms; and the same
    count in 64- and 128-byte units, the granularities in which the memory
    system may move them. Returns (bound bytes, sample bytes, {unit: floor
    bytes} for units 32, 64 and 128)."""
    n, J = block.n_series, params.num_steps
    T, B = block.vals.shape[1], block.vals.shape[2]
    width = B * 4
    sample_bytes = ts_bytes = 0
    unit_bytes = {32: 0, 64: 0, 128: 0}
    for r0 in range(0, n, 8192):
        r1 = min(n, r0 + 8192)
        pos = sampled_positions(block, params, windows, r0, r1)
        new = (pos[:, 1:] != pos[:, :-1]) & (pos[:, 1:] >= 0)
        sample_bytes += (int(new.sum()) + int((pos[:, 0] >= 0).sum())) * width
        # row s's sample k lies at byte (s * T + k) * width of vals
        rows = np.arange(r0, r1, dtype=np.int64)[:, None]
        pos_np = pos.cpu().numpy().astype(np.int64)
        off = (pos_np + rows * T) * width
        for unit in unit_bytes:
            first, last = off // unit, (off + width - 1) // unit
            units = np.concatenate([np.where((first + k <= last) & (pos_np >= 0), first + k, -1)
                                    for k in range((width + unit - 1) // unit + 1)], axis=1)
            units = np.sort(units, axis=1)
            distinct = (units[:, 1:] != units[:, :-1]) & (units[:, 1:] >= 0)
            unit_bytes[unit] += (int(distinct.sum()) + int((units[:, 0] >= 0).sum())) * unit
        if windows is None:
            ts_bytes += int(block.lens[r0:r1].sum()) * 4
    other = (n * 8 + 4 * J * 4 if windows is not None else ts_bytes + n * 12) + 2 * G * J * B * 4
    return sample_bytes + other, sample_bytes, {u: b + other for u, b in unit_bytes.items()}


def hist_split_libs() -> dict:
    """The histogram kernel's split builds (``tile_sweep.HIST_PATCHES``):
    "search only" and "fetch only" of the aggregate, "store: compute only"
    and "store: store only" of the store mode, each built apart and
    bound."""
    import importlib.util
    from pathlib import Path

    from filodb_tpu_torch.ops import hist_kernels as HK

    spec = importlib.util.spec_from_file_location(
        "tile_sweep", Path(__file__).resolve().parent / "tile_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    names = list(sweep.HIST_PATCHES)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = pool.map(lambda k: sweep.build_patched("hist_range", sweep.HIST_PATCHES[k],
                                                      HK.bind), names)
    return dict(zip(names, libs))


def time_hist_kernel(block, gids, G: int, params, windows, func: str, les, device,
                     phase: str, split_libs=None, rows_sweep=()) -> dict:
    """The histogram kernel on one block: alone and with the quantile folded
    in, per call (median of 20 between CUDA events) and back to back (50);
    the folded quantile's own ms is the difference. Beside them the bound,
    the sector floor, the plain versions' ms, the split builds (search only,
    fetch only) and, for each rows-per-tile count in ``rows_sweep``, the
    kernel at that layout."""
    import dataclasses

    import torch

    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import pad_steps

    J, B = params.num_steps, block.vals.shape[2]
    j_pad = pad_steps(J)
    plan = HK.hist_plan(block.vals.shape[1], J, B, G, windows is not None)
    acc, cnt, arrivals = HK.hist_buffers(G, j_pad * B, plan.slices, device)
    out = torch.full((G, j_pad), float("nan"), dtype=torch.float32, device=device)

    def launch(quantile: bool, lib=None, layout=None):
        fold = (0.99, les, out, arrivals) if quantile else None
        return lambda: HK._launch_range(func, block, gids, G, params, windows, False, acc, cnt,
                                        quantile=fold, plan=layout, lib=lib)

    gpu_sample(f"{phase} before")
    r_ms, r_b2b = cuda_ms(launch(False), reps=20), back_to_back_ms(launch(False))
    f_ms, f_b2b = cuda_ms(launch(True), reps=20), back_to_back_ms(launch(True))
    split = {}
    for name, lib in (split_libs or {}).items():
        if not name.startswith("store:"):  # the store mode's split: phase 12
            split[name] = back_to_back_ms(launch(False, lib=lib))
    sweep = {}
    for rows in rows_sweep:
        layout = dataclasses.replace(plan, rows=rows, smem_bytes=HK.hist_smem_bytes(
            G, B, plan.steps, rows, block.vals.shape[1], windows is not None, plan.shared,
            plan.staged))
        sweep[rows] = back_to_back_ms(launch(False, layout=layout))
    gpu_sample(f"{phase} after")
    grid_dims = HK.hist_grid(plan, block.vals.shape[0],
                             HK.resident_blocks(plan, windows is not None, device))
    rp_ms = cuda_ms(lambda: HK.hist_partials_plain(func, block, gids, G, params, windows),
                    reps=3, warmup=1)
    pa, pc = HK.hist_partials_plain(func, block, gids, G, params, windows)
    qp_ms = cuda_ms(lambda: HK.hist_quantile_plain(0.99, pa, pc, G, les, J), reps=3, warmup=1)
    del pa, pc
    bound, sample_bytes, floors = hist_bound_bytes(block, params, G, windows)
    floor = floors[32]
    q_bytes = 2 * G * J * B * 4 + B * 4 + G * J * 4
    to_ms = 1e3 / HBM_BYTES_PER_S
    split_note = "".join(f"; {k} {v:.4f} ms" for k, v in split.items())
    sweep_note = "".join(f"; rows per tile {k}: {v:.4f} ms" for k, v in sweep.items())
    print(f"{phase}: hist_range kernel {r_ms:.4f} ms (median of 20; {r_b2b:.4f} ms back to "
          f"back; {plan.partials} partials, {plan.rows} rows per tile, {plan.slices} slice(s), "
          f"float{plan.vec}, ts {'staged' if plan.staged else 'in place'}, grid {grid_dims}), "
          f"bound {bound * to_ms:.4f} ms ({bound} bytes at 3.35 TB/s, of which {sample_bytes} "
          f"bucket bytes at the windows' first and last samples), sector floor "
          f"{floor * to_ms:.4f} ms ({floor} bytes; in 64-byte units {floors[64] * to_ms:.4f} ms, "
          f"in 128-byte units {floors[128] * to_ms:.4f} ms), plain {rp_ms:.2f} ms; with the quantile "
          f"folded in {f_ms:.4f} ms ({f_b2b:.4f} ms back to back): the fold adds "
          f"{f_ms - r_ms:.4f} ms ({f_b2b - r_b2b:.4f} back to back), its bytes' bound "
          f"{q_bytes * to_ms:.6f} ms ({q_bytes} bytes), plain quantile {qp_ms:.3f} ms"
          f"{split_note}{sweep_note}")
    return {"range_ms": r_ms, "range_ms_back_to_back": r_b2b, "range_plain_ms": rp_ms,
            "range_bound_ms": bound * to_ms, "range_bound_bytes": bound,
            "range_sample_bytes": sample_bytes, "sector_floor_ms": floor * to_ms,
            "sector_floor_bytes": floor, "floor_64b_ms": floors[64] * to_ms,
            "floor_128b_ms": floors[128] * to_ms, "partials": plan.partials, "rows": plan.rows,
            "slices": plan.slices, "vec": plan.vec, "threads": plan.threads,
            "staged": plan.staged,
            "grid": list(grid_dims), "smem_bytes": plan.smem_bytes,
            "folded_ms": f_ms, "folded_ms_back_to_back": f_b2b,
            "quantile_ms": f_ms - r_ms, "quantile_ms_back_to_back": f_b2b - r_b2b,
            "quantile_plain_ms": qp_ms, "quantile_bound_ms": q_bytes * to_ms,
            "split_ms_back_to_back": split, "rows_sweep_ms_back_to_back": sweep}


def time_hist_kernels(entry, ex, device, phase: str, split_libs=None) -> dict:
    """The kernel on the query's superblock (``time_hist_kernel``) and the
    device path (the wrapper: buffers, one launch, output), per call and
    back to back. On shared bounds also the large-G tail: the same block
    grouped 1000 ways, where the last block of the slice interpolates G x J
    quantiles alone."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops.kernels import pad_steps

    block = entry.block
    gids, G, params = path_args(entry, ex)
    windows = (AGG._hist_shared_windows(block, params, pad_steps(ex.num_steps()))
               if block.regular_ts is not None else None)
    q = float(ex.hist_quantile)
    timing = time_hist_kernel(block, gids, G, params, windows, ex.function, entry.les_dev,
                              device, phase, split_libs)

    def device_path():
        AGG.fused_hist_range_aggregate(ex.function, block, gids, G, params, entry.les_dev, q=q)

    d_ms, d_b2b = cuda_ms(device_path, reps=20), back_to_back_ms(device_path)
    print(f"{phase}: device path (buffers, one launch, output) {d_ms:.4f} ms "
          f"({d_b2b:.4f} ms back to back)")
    timing.update(device_path_ms=d_ms, device_path_ms_back_to_back=d_b2b)
    if windows is not None:
        g1000 = torch.full_like(gids, 1000)
        g1000[: block.n_series] = torch.arange(block.n_series, device=device) % 1000
        tail = time_hist_kernel(block, g1000, 1000, params, windows, ex.function,
                                entry.les_dev, device, f"{phase} G=1000")
        timing["g1000"] = {k: tail[k] for k in (
            "range_ms_back_to_back", "folded_ms_back_to_back", "quantile_ms_back_to_back",
            "partials", "slices", "grid")}
    return timing


def hist_cold_warm(engine, phase: str, want_class: str, want_variant: str) -> dict:
    """The canonical query cold (a superblock build), then warm (a cache hit
    with no staging); one launch of the histogram range kernel each time,
    the quantile folded into it; the warm [G, J] equals the cold one (rtol
    1e-3). Then ``sum by (le)`` of the same selection, warm: one launch, no
    quantile."""
    import torch

    res, cold, cold_s, counts = run_hist(engine, HIST_QUERY, want_class, want_variant)
    launches = add_launches({}, counts)
    require(res.stats.cache_misses >= 1 and res.stats.cache_hits == 0,
            f"{phase}: the first query must build the superblock, stats {res.stats}")
    res, warm, warm_s, counts = run_hist(engine, HIST_QUERY, want_class, want_variant)
    launches = add_launches(launches, counts)
    st = res.stats
    require(st.cache_hits == 1 and st.cache_misses == 0 and st.bytes_staged == 0,
            f"{phase}: the warm query must be a cache hit with no staging, stats {st}")
    compare(torch.from_numpy(warm), torch.from_numpy(cold), f"{phase}: warm vs cold", rtol=1e-3)
    require(warm.shape == (1, res.grids[0].num_steps), f"{phase}: [G, J] shape {warm.shape}")
    require(np.isfinite(warm[0, 5:]).all(), f"{phase}: non-finite quantiles")
    sum_res, _, sum_s, counts = run_hist(engine, HIST_SUM_QUERY, want_class, want_variant,
                                         folds=0)
    launches = add_launches(launches, counts)
    sums = sum_res.grids[0].hist_np()
    require(sum_res.stats.cache_hits == 1 and sums is not None and sums.shape[-1] == N_BUCKETS,
            f"{phase}: sum by (le) must hit the cached superblock, stats {sum_res.stats}")
    print(f"{phase} {HIST_QUERY!r}: grid {want_class}, variant {want_variant}, "
          f"{st.series_scanned} series, {st.samples_scanned} samples; cold {cold_s * 1e3:.1f} ms "
          f"(cache miss), warm {warm_s * 1e3:.1f} ms (hit, no staging); one hist_range launch "
          f"each with the quantile folded in, no other kernel; warm [G, J] equals cold (rtol "
          f"1e-3); {HIST_SUM_QUERY!r} warm {sum_s * 1e3:.1f} ms, one launch, no quantile")
    return {"res": res, "vals": warm, "cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3,
            "launches": launches}


def hist_live_batch(tags_list, slot: int):
    """One sample per series at ``slot``: bucket counts above every series'
    earlier ones (cumulative over the buckets and in time)."""
    from filodb_tpu_torch.core.records import RecordBatch
    from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM

    n = len(tags_list)
    h = np.broadcast_to(np.cumsum(np.full(N_BUCKETS, 1e5)) + slot, (n, N_BUCKETS)).copy()
    return RecordBatch(PROM_HISTOGRAM, np.full(n, BASE + slot * 10_000, np.int64),
                       {"sum": h[:, -1] * 0.01, "count": h[:, -1], "h": h}, tags_list,
                       HIST_LES)


def phase_hist_live_edge(engine, device) -> dict:
    """7b's live edge: the canonical query to past the newest sample (cold,
    a build), one batch of one sample per series through ``ingest_routed``,
    the query again: it must extend the cached superblock (not restage),
    leave the held block unchanged, and equal the plain path on a superblock
    built afresh from the final store, whose real ts, lens and vals equal
    the extended block's bit for bit."""
    import torch

    from filodb_tpu_torch import metrics as M

    ev0 = M.superblock_events()
    res, _, cold_s, counts = run_hist(engine, HIST_QUERY, "regular", "hist_shared",
                                      end_s=LIVE_END_S)
    launches = add_launches({}, counts)
    require(res.stats.cache_misses >= 1, f"7b live edge: expected a build, stats {res.stats}")
    ex = exec_node(engine, HIST_QUERY, LIVE_END_S)
    held = ex.superblock(engine.context())
    held_vals = held.block.vals.clone()
    held_len = int(held.block.lens[0])
    tags_list = [hist_tags(i) for i in range(N_SERIES)]
    t0 = time.perf_counter()
    engine.memstore.ingest_routed("prometheus", hist_live_batch(tags_list, N_SAMPLES),
                                  spread=SPREAD)
    ingest_s = time.perf_counter() - t0
    res, final, ext_s, counts = run_hist(engine, HIST_QUERY, "regular", "hist_shared",
                                         end_s=LIVE_END_S)
    launches = add_launches(launches, counts)
    require(res.stats.cache_extends == 1, f"7b live edge: the append must extend, {res.stats}")
    ext = extension_record()
    events = {k: v - ev0[k] for k, v in M.superblock_events().items()}
    require(events == {"revalidate": 0, "extend": 1, "extend_abort": 0, "restage": 0},
            f"7b live edge: maintenance outcomes {events}")
    require(torch.equal(held.block.vals, held_vals) and int(held.block.lens[0]) == held_len,
            "7b live edge: the extension wrote the held block")
    del held_vals
    ext_block = ex.superblock(engine.context()).block
    require(int(ext_block.lens[0]) == held_len + 1, "7b live edge: extended length")
    ex, fresh, fresh_s = stage_again(engine, HIST_QUERY, LIVE_END_S)
    fb, n = fresh.block, fresh.block.n_series
    for k in ("ts", "vals"):
        require(torch.equal(getattr(fb, k)[:n], getattr(ext_block, k)[:n]),
                f"7b live edge: extended {k} differs from a fresh build's")
    require(torch.equal(fb.lens, ext_block.lens), "7b live edge: extended lens differ")
    err = compare(torch.from_numpy(final).to(device), hist_plain(fresh, ex, 0.99),
                  "7b live edge: final query vs the plain path on a fresh build", rtol=1e-3)
    print(f"phase7b live edge ({HIST_QUERY!r} to {LIVE_END_S:.0f} s): cold {cold_s * 1e3:.1f} ms; "
          f"one {N_SERIES}-row ingest_routed batch in {ingest_s:.2f} s; the next query extended "
          f"the superblock in {ext_s * 1e3:.1f} ms end to end ({ext['bytes_uploaded']} bytes "
          f"uploaded; host {ext['proof_ms'] + ext['host_ms']:.1f} ms, device "
          f"{ext['device_ms']:.3f} ms); outcomes {events}; held block unchanged; extended ts, "
          f"lens and vals bit-equal to a fresh build ({fresh_s:.2f} s); final [G, J] matches "
          f"the plain path (max_abs_err {err:.3g})")
    return {"cold_ms": cold_s * 1e3, "extend_query_ms": ext_s * 1e3, "ingest_s": ingest_s,
            "extension": ext, "outcomes": events, "fresh_build_s": fresh_s,
            "final_max_abs_err": err, "launches": launches}


def phase_hist_bench(device, split_libs):
    """7b: bench.py's hist_quantile workload end to end. Returns its numbers,
    its engine (phase 12 runs on the same store) and phase 16's jittered
    store, built from the same draws."""
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import staging as ST

    t0 = time.perf_counter()
    stores = build_memstore_hists(N_SERIES, ("regular", "jitter"))
    ms = stores["regular"]
    print(f"phase7b ingest: {N_SERIES} histogram series x {N_SAMPLES} samples x {N_BUCKETS} "
          f"buckets (bench.py's build_memstore_hist, seed {HIST_SEED}) on {N_SHARDS} shards, "
          f"and phase 16's store of the same draws on bench.py's fused_jitter timestamps, in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    run = hist_cold_warm(engine, "phase7b", "regular", "hist_shared")
    ex = exec_node(engine, HIST_QUERY)
    entry = ex.superblock(engine.context())
    got = torch.from_numpy(run["vals"]).to(device)
    err = compare(got, hist_plain(entry, ex, 0.99), "7b: [G, J] vs the plain path", rtol=1e-3)
    t0 = time.perf_counter()
    ref = cpu_baseline_hist(ms)
    oracle_s = time.perf_counter() - t0
    with np.errstate(invalid="ignore"):
        match = np.allclose(run["vals"][0], ref, rtol=5e-3, equal_nan=True)
    require(match, f"7b: [G, J] differs from bench.py's f64 oracle: {run['vals'][0][:8]} vs "
                   f"{ref[:8]}")
    nbytes = ST.staged_nbytes(entry.block)
    print(f"phase7b: superblock {list(entry.block.vals.shape)} ({nbytes} bytes on the card); "
          f"[G, J] matches the plain path (max_abs_err {err:.3g}) and bench.py's f64 oracle "
          f"(rtol 5e-3, {oracle_s:.1f} s on the host)")
    range_err, q_err = check_hist_partials(entry, ex, "phase7b")
    timing = time_hist_kernels(entry, ex, device, "phase7b", split_libs)
    del entry
    live = phase_hist_live_edge(engine, device)
    return {"cold_ms": run["cold_ms"], "warm_ms": run["warm_ms"], "superblock_bytes": nbytes,
            "max_abs_err": err, "range_max_abs_err": range_err, "quantile_max_abs_err": q_err,
            "launches": add_launches(run["launches"], live["launches"]), **timing,
            "live_edge": live}, engine, stores["jitter"]


def phase_hist_irregular(device, n_series: int, split_libs):
    """7c: the per-series bounds entry at scale: the same store on irregular
    5-15 s scrapes, the canonical query cold then warm on ``hist_general``,
    against the plain path. Returns its numbers and its engine."""
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine

    t0 = time.perf_counter()
    ms = build_memstore_hist(n_series, "irregular")
    print(f"phase7c ingest: {n_series} histogram series x {N_SAMPLES} samples at irregular "
          f"5-15 s intervals in {time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    run = hist_cold_warm(engine, "phase7c", "irregular", "hist_general")
    ex = exec_node(engine, HIST_QUERY)
    entry = ex.superblock(engine.context())
    err = compare(torch.from_numpy(run["vals"]).to(device), hist_plain(entry, ex, 0.99),
                  "7c: [G, J] vs the plain path", rtol=1e-3)
    print(f"phase7c: superblock {list(entry.block.vals.shape)}; [G, J] matches the plain path "
          f"(max_abs_err {err:.3g})")
    range_err, q_err = check_hist_partials(entry, ex, "phase7c")
    timing = time_hist_kernels(entry, ex, device, "phase7c", split_libs)
    del entry
    return {"series": n_series, "cold_ms": run["cold_ms"], "warm_ms": run["warm_ms"],
            "max_abs_err": err, "range_max_abs_err": range_err, "quantile_max_abs_err": q_err,
            "launches": run["launches"], **timing}, engine


def hist_block_bulk_on_card(n_real: int, m: int, seed: int, device):
    """``hist_block_on_card``'s irregular histograms drawn in bulk on the
    card from a seeded torch generator: per series a length in [m/2, m]
    (series n_real/2 empty), 5-15 s intervals, Poisson(2) increments per
    bucket with the +Inf bucket their sum, cumulative over the buckets and
    in time (integers, exact in f32), NaN counts in series 3; padded rows
    and samples as staging pads them."""
    import torch

    from filodb_tpu_torch.ops.staging import TS_PAD, StagedBlock, pad_series, pad_time

    gen = torch.Generator(device=device).manual_seed(seed)
    S, T = pad_series(n_real), pad_time(m)
    lens = torch.zeros(S, dtype=torch.int32, device=device)
    lens[:n_real] = torch.randint(m // 2, m + 1, (n_real,), generator=gen, device=device,
                                  dtype=torch.int32)
    lens[n_real // 2] = 0
    ts = torch.full((S, T), int(TS_PAD), dtype=torch.int32, device=device)
    vals = torch.zeros((S, T, N_BUCKETS), dtype=torch.float32, device=device)
    lane = torch.arange(T, device=device)
    for r0 in range(0, n_real, 8192):
        r1 = min(n_real, r0 + 8192)
        live = lane[None, :] < lens[r0:r1, None]
        gaps = torch.randint(5_000, 15_001, (r1 - r0, T), generator=gen, device=device)
        ts[r0:r1] = torch.where(live, torch.cumsum(gaps, dim=1), int(TS_PAD)).to(torch.int32)
        incr = torch.poisson(torch.full((r1 - r0, T, N_BUCKETS), 2.0, device=device),
                             generator=gen)
        incr[..., -1] = incr.sum(-1)
        h = torch.cumsum(torch.cumsum(incr, dim=2), dim=1)
        vals[r0:r1] = torch.where(live[..., None], h, 0.0)
    vals[3, 20:24, 2] = float("nan")
    block = StagedBlock(ts, vals, lens, BASE, torch.zeros((S, N_BUCKETS), device=device),
                        n_real, [])
    require(block.regular_ts is None and int(lens.max()) <= m, "card block: irregular rows")
    return block


def phase_hist_card_block(device, split_libs) -> dict:
    """The per-series bounds at PR 5's 100k-series shape without a host
    build: 100k irregular 12-bucket histograms made on the card
    (``hist_block_bulk_on_card``, 720 samples at most), the canonical rate
    over bench.py's range into one group, with the quantile folded in. The
    partials and the folded quantile against plain (rtol 1e-3); the
    kernel's times beside the bound, the sector floor, the split builds and
    each rows-per-tile layout."""
    import torch

    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import RangeParams

    t0 = time.perf_counter()
    block = hist_block_bulk_on_card(N_SERIES, N_SAMPLES, HIST_SEED, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    S = block.vals.shape[0]
    num_steps = int((END_S - START_S) // STEP_S) + 1
    params = RangeParams(int(START_S * 1000), int(STEP_S * 1000), num_steps, WINDOW_MS)
    gids = torch.ones(S, dtype=torch.int64, device=device)
    gids[:N_SERIES] = 0
    les = torch.tensor(HIST_LES, dtype=torch.float32, device=device)
    out, acc, cnt = HK.hist_range_quantile(0.5, "rate", block, gids, 1, params, les)
    pa, pc = HK.hist_partials_plain("rate", block, gids, 1, params)
    require(torch.equal(cnt[:1], pc[:1]), "card block: member counts differ from plain")
    range_err = compare(GA.finish_groups("sum", acc, cnt, 1), GA.finish_groups("sum", pa, pc, 1),
                        "card block: hist_range partials vs plain", rtol=1e-3)
    q_err = compare(out, HK.hist_quantile_plain(0.5, acc, cnt, 1, les, num_steps),
                    "card block: folded quantile vs plain", rtol=1e-3)
    del out, acc, cnt, pa, pc
    print(f"phase7d: {N_SERIES} irregular histogram series made on the card in {build_s:.1f} s, "
          f"block {list(block.vals.shape)}; hist_range partials match plain (max_abs_err "
          f"{range_err:.3g}), the folded quantile too (max_abs_err {q_err:.3g})")
    timing = time_hist_kernel(block, gids, 1, params, None, "rate", les, device, "phase7d",
                              split_libs, rows_sweep=(2, 4, 8))
    return {"series": N_SERIES, "build_s": build_s, "range_max_abs_err": range_err,
            "quantile_max_abs_err": q_err, **timing}


# -- phase 2d: the reference tree's kernels against their plain versions -----------

TREE_SORTED_CASES = [("quantile_over_time", (q,)) for q in (-0.1, 0.0, 0.5, 0.9, 1.0, 1.1)] + [
    ("median_absolute_deviation_over_time", ()), ("last_over_time_is_mad_outlier", (2.0, 1.0))]
TREE_ARG_CASES = (("predict_linear", (600.0,)), ("predict_linear", (-45.5,)),
                  ("double_exponential_smoothing", (0.3, 0.1)),
                  ("double_exponential_smoothing", (0.9, 0.5)))


def phase_tree_kernels_vs_plain(seed: int, device, sizes=(1, 65, 4096)) -> dict:
    """Phase 2d: the sorted-window kernel (K2) and the general kernel's
    predict_linear and Holt-Winters (K3) against their plain versions on
    seeded blocks (``window_block``): S in {1, 65, 4096} x T in {128, 768}
    on irregular and regular grids, gauge and shifted-counter values (tied
    timestamps, NaN samples, a row with no sample; 8 s windows at T = 128,
    empty and one-sample, 5 m at 768), and 5 s rows with 1 h windows of up
    to 720 samples (the sorted kernel's warp route), one block of them 8192
    wide (rows read in place); q in {-0.1, 0, 0.5,
    0.9, 1, 1.1}. Sorted: within 2 ulp (order statistics bit-equal), NaN
    masks and infinities equal; predict_linear and Holt-Winters: rtol 2e-4
    / atol 1e-4, NaN masks equal. Then the standalone quantile (K1) on
    seeded classic rows (``gather_inputs``: G in {1, 8,
    1000, 3000} x B in {1, 2, 12, 33, 64} x q in {-0.1, 0, 0.5, 0.99, 1,
    1.1}), bit-equal, NaN masks too, and no out row written but its own."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops import sorted_window as SW
    from filodb_tpu_torch.ops.kernels import RangeParams

    blocks = [(kind, S, T, counter, 300_000 if T == 768 else 8_000)
              for S in sizes for T in (128, 768) for kind in ("irregular", "regular")
              for counter in (False, True)]
    blocks += [("long", S, 768, counter, 3_600_000) for S in sizes for counter in (False, True)]
    blocks.append(("long", sizes[1], 8_192, False, 3_600_000))  # rows read in place
    worst_ulp, arg_err, launches, long_windows = 0, 0.0, 0, 0
    for i, (kind, S, T, counter, window) in enumerate(blocks):
        b = window_block(S, T, kind, counter, seed + i, device)
        start = BASE + (3_000_000 if kind == "long" else -60_000)
        params = RangeParams(start, 30_000, 120, window)
        for func, args in TREE_SORTED_CASES:
            got = SW.sorted_window(func, b, params, args)
            launches += 1
            q, a1 = SW.func_args(args)
            want = SW.sorted_window_plain(func, b.ts, b.vals, b.lens, int(start - BASE),
                                          30_000, window, 120, q, a1)
            want[S:] = float("nan")
            gap = ulp_gap(got[:, :120], want)
            require(gap <= 2, f"2d sorted {func}{args} {kind} S={S} T={T}: {gap} ulp")
            require(SW.LAST_PLAN == SW.sorted_plan(T) and SW.LAST_PLAN.staged == (T < 8_192),
                    f"2d: the sorted plan at T = {T}")
            worst_ulp = max(worst_ulp, gap)
        if kind == "long":
            from filodb_tpu_torch.ops.kernels import _bounds

            out_t = (int(start - BASE) + torch.arange(120, device=device) * 30_000).to(torch.int32)
            lo, hi = _bounds(b.ts, b.lens, out_t, torch.tensor(window, dtype=torch.int32,
                                                               device=device))
            long_windows += int(((hi - lo) > SW.LANE_CAP).sum())
        gids = AGG.zero_gids(b)
        for func, args in TREE_ARG_CASES:
            got = GR.general_range_series(func, b, gids, 1, params, args=args)
            launches += 1
            want = GA.series_grid(GR.general_range_series_plain(func, b, params, args=args), gids,
                                  1, 120)
            arg_err = max(arg_err, compare(got, want, f"2d {func}{args} {kind} S={S} T={T}",
                                           rtol=2e-4, atol=1e-4))
    require(long_windows > 0, "2d: no window reached the warp's radix route")
    gather_err, gather_cases = 0.0, 0
    for G in GATHER_GROUPS:
        for B in GATHER_BUCKETS:
            part, table, rows, les_t, n_out = gather_inputs(G, B, 111, seed + G + B, device)
            HK.check_gather_table(table, rows, les_t)
            for q in GATHER_QS:
                out = torch.full((n_out, 128), float("nan"), device=device)
                HK.histogram_quantile_gather(q, part, table, rows, les_t, 111, out)
                want = torch.full_like(out, float("nan"))
                want[rows.long(), :111] = HK.histogram_quantile_gather_plain(
                    q, part, table, les_t, 111)
                m = ~torch.isnan(want)
                require(torch.equal(torch.isnan(out), ~m) and torch.equal(out[m], want[m]),
                        f"2d hist_quantile_gather G={G} B={B} q={q}: differs from plain")
                gather_err = max(gather_err, float((out[m] - want[m]).abs().max())
                                 if m.any() else 0.0)
                gather_cases += 1
    print(f"phase2d sorted_window ({len(TREE_SORTED_CASES)} functions x {len(blocks)} blocks, "
          f"{long_windows} windows past the {SW.LANE_CAP}-sample lane cap on the warp's radix "
          f"route, rows of 8192 read in place) within "
          f"{worst_ulp} ulp of plain; predict_linear and Holt-Winters on the general kernel "
          f"match plain (max_abs_err {arg_err:.3g}); hist_quantile_gather bit-equal to plain "
          f"in {gather_cases} cases (G {GATHER_GROUPS}, B {GATHER_BUCKETS}, q {GATHER_QS}; "
          f"groups with no member, rows < 0)")
    return {"sorted_max_ulp": worst_ulp, "arg_max_abs_err": arg_err, "launches": launches,
            "radix_windows": long_windows, "gather_max_abs_err": gather_err,
            "gather_cases": gather_cases}


GATHER_GROUPS = (1, 8, 1_000, 3_000)  # phase 2d's classic quantile groups
GATHER_BUCKETS = (1, 2, 12, 33, 64)
GATHER_QS = (-0.1, 0.0, 0.5, 0.99, 1.0, 1.1)


def gather_inputs(G: int, B: int, J: int, seed: int, device):
    """(part, table, rows, les, out rows) of G classic groups of B buckets:
    cumulative counts in the rows of a by-(le, ...) aggregate's partials
    ([G * B + 7, 128], a few counts absent), the groups' rows in a drawn
    order, every 5th group with no member (all its rows NaN), every 7th
    group with one table entry < 0, bounds with a first one <= 0 in every
    other scheme; the quantiles go to every other of 2 G out rows."""
    import torch

    rng = np.random.default_rng(seed)
    les = np.sort(rng.uniform(0.05, 50.0, B - 1)).astype(np.float32)
    if B > 1 and seed % 2:
        les[0] = -1.0
    les = np.concatenate([les, [np.inf]]).astype(np.float32)
    n_rows = G * B + 7
    part = np.full((n_rows, 128), np.nan, np.float32)
    counts = np.cumsum(rng.poisson(3.0, (G, B, 111)), axis=1).astype(np.float32)
    counts[rng.random(counts.shape) < 0.02] = np.nan
    counts[::5] = np.nan  # a group with no member
    perm = rng.permutation(n_rows)[: G * B]
    part[perm, :J] = counts.reshape(G * B, 111)[:, :J]
    table = perm.reshape(G, B).astype(np.int32)
    table[::7, B // 2] = -1
    rows = (2 * rng.permutation(G) + 1).astype(np.int32)
    return (torch.tensor(part, device=device), torch.tensor(table, device=device),
            torch.tensor(rows, device=device), torch.tensor(les, device=device), 2 * G)


# -- phase 10: the reference tree at full width ------------------------------------

# (query, rung on the irregular store, rung on the regular store)
TREE_QUERIES = (
    ("rate(http_requests_total[5m])", "window_stats", "mxu"),
    ("http_requests_total", None, "mxu"),
    ("irate(http_requests_total[5m])", "general", "mxu"),
    ("quantile_over_time(0.9, http_requests_total[5m])", "sorted", "sorted"),
    ("mad_over_time(http_requests_total[5m])", "sorted", None),
    ("predict_linear(http_requests_total[5m], 600)", "general", "mxu"),
    ("holt_winters(http_requests_total[5m], 0.3, 0.1)", "general", "general"),
    ("timestamp_of_last_sample(http_requests_total[5m])", None, "host"),
    ("rate(http_requests_total[5m] offset 1m)", None, "mxu"),
)
# run once on one store (None: not run there), its rows checked, its kernel
# not timed: the script's time
TREE_ONCE = frozenset({"http_requests_total", "mad_over_time(http_requests_total[5m])",
                       "rate(http_requests_total[5m] offset 1m)"})
TREE_KERNELS = {"mxu": "regular_range", "window_stats": "window_range",
                "general": "general_range", "sorted": "sorted_window", "host": None,
                "jitter": "jitter_range", "masked": "masked_range"}
# operations per in-window sample of the tree's general functions, and their rate
TREE_GENERAL_OPS = {"irate": (0, F32_OPS_PER_S), "predict_linear": (6, F64_OPS_PER_S),
                    "double_exponential_smoothing": (8, F32_OPS_PER_S)}


def run_tree(engine, q: str, rung: str):
    """One unaggregated query through the user's entry point, every launch
    count set to 0 just before and read just after: each shard leaf must
    take ``rung`` and launch its kernel once (none for the host rung), and
    no other kernel may launch. Returns the result, its [S, J] rows on the
    host and the end-to-end seconds."""
    import importlib

    from filodb_tpu_torch.ops import kernels as K

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in KERNEL_COUNTERS.items()}
    seen = []
    dispatch = K._dispatch_range_function

    def watched(*a, **k):
        out = dispatch(*a, **k)
        seen.append(out[1])
        return out

    K._dispatch_range_function = watched
    try:
        for name, (_, attr) in KERNEL_COUNTERS.items():
            setattr(mods[name], attr, 0)
        t0 = time.perf_counter()
        res = engine.query_range(q, START_S, END_S, STEP_S)
        rows = np.concatenate([g.values_np() for g in res.grids])
        wall = time.perf_counter() - t0
        counts = {name: getattr(mods[name], attr) for name, (_, attr) in KERNEL_COUNTERS.items()}
    finally:
        K._dispatch_range_function = dispatch
    leaves = len(res.grids)
    require(seen == [rung] * leaves, f"{q}: rungs {seen}, expected {rung} on {leaves} leaves")
    want = {k: leaves if k == TREE_KERNELS[rung] else 0 for k in KERNEL_COUNTERS}
    require(counts == want, f"{q}: launches {counts}, expected {want}")
    return res, rows, wall


def tree_leaves(engine, q: str):
    """The query's leaves with their staged selections (warm: served from
    the shards' staging caches, the device copies the query read): a list
    of (mapper, RawGrid)."""
    from filodb_tpu_torch.query.exec.plans import SelectRawPartitionsExec

    plan = exec_node(engine, q)
    leaves = plan.children() if plan.children() else [plan]
    ctx = engine.context()
    out = []
    for leaf in leaves:
        require(isinstance(leaf, SelectRawPartitionsExec), f"{q}: a leaf is {type(leaf)}")
        for rg in leaf.do_execute(ctx).raw_grids:
            out.append((leaf.transformers[0], rg))
    require(ctx.stats.cache_misses == 0 and ctx.stats.bytes_staged == 0,
            f"{q}: the leaves' warm reads staged ({ctx.stats})")
    return out


def tree_plain(mapper, rg):
    """The leaf's [S, J] values through the plain version of its rung, on
    the card."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import sorted_window as SW
    from filodb_tpu_torch.ops.kernels import range_kernel_plain

    func, params, b = mapper.function or "last", mapper.range_params(), rg.block
    J, start_off = params.num_steps, int(params.start_ms - b.base_ms)
    variant = tree_variant(mapper, rg)
    if variant == "host":  # the f32 ms offset of the last sample, exact below 2^24 ms
        raw = b.raw if b.raw is not None else b.vals
        t = range_kernel_plain("timestamp", b.ts, b.vals, b.lens, b.baseline, raw, start_off,
                               params.step_ms, params.window_ms, J)
        return (t.double() + b.base_ms) / 1e3
    if variant == "sorted":
        q, a1 = SW.func_args(mapper.args)
        return SW.sorted_window_plain(func, b.ts, b.vals, b.lens, start_off, params.step_ms,
                                      params.window_ms, J, q, a1)
    return AGG.rung_series_plain(variant, func, b, params, rg.is_counter, rg.is_delta,
                                 mapper.args)[:, :J]


def tree_variant(mapper, rg) -> str:
    from filodb_tpu_torch.ops import kernels as K

    return K.tree_rung(mapper.function or "last", rg.block, mapper.range_params(),
                       rg.is_delta, mapper.args)


def tree_launch(mapper, rg):
    """One store-mode (or sorted-window) launch of the leaf's rung into a
    buffer of its own, for timing: returns the launch as a closure."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import sorted_window as SW
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    func, params, b = mapper.function or "last", mapper.range_params(), rg.block
    J, S = params.num_steps, b.ts.shape[0]
    variant = tree_variant(mapper, rg)
    gids = AGG.zero_gids(b)
    if variant == "sorted":
        out = torch.full((S, pad_steps(J)), float("nan"), device=b.ts.device)
        q, a1 = SW.func_args(mapper.args)
        return lambda: SW._launch(func, b, params, q, a1, out)
    out = GA.series_buffer(S, pad_steps(J), J, b.ts.device)
    if variant == "general":
        return lambda: GR._launch(func, GA.STORE, b, gids, 1, params, rg.is_counter, rg.is_delta,
                                  out, out, args=mapper.args)
    if variant == "window_stats":
        return lambda: WS._launch_range(func, GA.STORE, b, gids, 1, params, rg.is_counter,
                                        rg.is_delta, out, out)
    if variant in ("jitter", "masked"):
        return jitter_launch(variant, func, b, gids, 1, params, rg.is_counter, rg.is_delta,
                             GA.STORE, out, out)
    raw = b.raw if b.raw is not None else b.vals
    wm = MK.window_matrices(b, int(params.start_ms - b.base_ms), params.step_ms, pad_steps(J),
                            params.window_ms)
    return lambda: MK._launch(func, GA.STORE, b.vals, raw, gids, 1, wm, J, rg.is_counter,
                              rg.is_delta, out, out, args=mapper.args)


def tree_bound(leaves, variant: str) -> dict:
    """The least time of the query's launches (one per leaf): bytes (each
    real sample's timestamp and value read once -- the value alone on the
    regular rung, raw too where the rung reads it -- each row's length,
    the [S, J] output written once) over 3.35 TB/s, or the operations of
    this run's windows over the peak rate of their type: the sorted
    windows' n log2 n comparisons, the general functions' per-sample
    arithmetic (``TREE_GENERAL_OPS``), whichever is larger."""
    import torch

    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import _bounds

    need = ops = samples = 0
    rate = F32_OPS_PER_S
    for mapper, rg in leaves:
        b, params, func = rg.block, mapper.range_params(), mapper.function or "last"
        n, J = rg.block.n_series, params.num_steps
        real = int(b.host_block.lens.sum()) if b.host_block is not None else int(b.lens.sum())
        if variant in ("jitter", "masked"):
            need += jitter_bound_bytes(variant, func, b, n, J, rg.is_counter, rg.is_delta)
            need += n * J * 4
            continue
        per = {"mxu": 4 * (2 if rg.is_counter and func in ("rate", "increase") else 1),
               "window_stats": 4 * WS.staged_arrays(func, rg.is_counter, rg.is_delta),
               "general": 4 * GR.staged_arrays(func, rg.is_counter, rg.is_delta),
               "sorted": 8}[variant]
        need += real * per + n * 4 + n * J * 4
        if variant in ("sorted", "general"):
            dev = b.ts.device
            out_t = (int(params.start_ms - b.base_ms)
                     + torch.arange(J, device=dev, dtype=torch.int64) * params.step_ms
                     ).to(torch.int32)
            lo, hi = _bounds(b.ts[:n], b.lens[:n], out_t,
                             torch.tensor(params.window_ms, dtype=torch.int32, device=dev))
            w = (hi - lo).clamp(min=0).double()
            samples += int(w.sum())
            if variant == "sorted":
                ops += float((w * torch.log2(torch.clamp(w, min=1.0))).sum())
            else:
                per_sample, rate = TREE_GENERAL_OPS[func]
                ops += int(w.sum()) * per_sample
    bytes_ms, ops_ms = need / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bound_bytes": need,
            "bytes_ms": bytes_ms, "operations": ops, "operations_ms": ops_ms,
            "window_samples": samples}


def dev_copies(engine) -> dict:
    """id of every staging-cache entry's device copy, by (shard, key)."""
    ms = engine.memstore
    return {(s, k): id(e.dev_block) for s in ms.shard_nums(engine.dataset)
            for k, e in ms.shard(engine.dataset, s).stage_cache.items()}


def host_split(engine, q: str) -> dict:
    """A warm query taken apart on the host: planning, the plan's execution
    (cache hits, launches, the label strip), the label strip alone, and the
    D2H of the [S, J] rows."""
    import torch

    from filodb_tpu_torch.query.exec.transformers import _strip_metric
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    t0 = time.perf_counter()
    plan = engine.planner.materialize(query_range_to_logical_plan(q, START_S, END_S, STEP_S))
    t1 = time.perf_counter()
    res = plan.execute(engine.context())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for g in res.grids:
        g.values_np()
    t3 = time.perf_counter()
    labels = [l for g in res.grids for l in g.labels]
    t4 = time.perf_counter()
    [_strip_metric(l) for l in labels]
    t5 = time.perf_counter()
    return {"plan_ms": (t1 - t0) * 1e3, "execute_ms": (t2 - t1) * 1e3, "d2h_ms": (t3 - t2) * 1e3,
            "label_strip_ms": (t5 - t4) * 1e3}


def phase_tree(engine, card: str, grid: str, sum_rate: np.ndarray) -> dict:
    """Phase 10: the reference tree on a 100k-series store (phase 4's
    irregular or phase 5's regular one): every ``TREE_QUERIES`` query
    through ``QueryEngine`` twice -- first (the phase's first query with
    fresh caches, every shard staged again; later ones on the caches their
    predecessors left, a miss where their staging mode is new) then warm
    (every shard leaf a staging-cache hit on the same device copy: nothing
    staged, nothing uploaded) -- one launch of its rung's
    kernel per leaf and no other kernel; the [S, J] rows against the
    plain path on the card (rtol 1e-3, NaN masks equal); rate summed on
    the host against phase 4/5's sum(rate) (rtol 1e-3). Prints cold and
    warm latency, the host split and the kernel's ms beside its bound and
    the plain version's ms."""
    import torch

    out = {}
    for q, irr_rung, reg_rung in TREE_QUERIES:
        rung = reg_rung if grid == "regular" else irr_rung
        if rung is None:  # not run on this store
            continue
        if q == TREE_QUERIES[0][0]:
            cold_cache(engine)  # the phase's first query only: the others may hit
        cold, cold_rows, cold_s = run_tree(engine, q, rung)
        if q not in TREE_ONCE:
            copies = dev_copies(engine)
            warm, rows, warm_s = run_tree(engine, q, rung)
            st = warm.stats
            require(st.cache_hits == len(warm.grids) and st.cache_misses == 0
                    and st.bytes_staged == 0,
                    f"{q}: the warm run must hit every leaf's staging cache, stats {st}")
            require(dev_copies(engine) == copies, f"{q}: the warm run made new device copies")
            require(np.array_equal(np.isnan(rows), np.isnan(cold_rows)) and np.allclose(
                rows, cold_rows, rtol=1e-3, equal_nan=True), f"{q}: warm differs from cold")
        else:
            warm, rows, warm_s = cold, cold_rows, cold_s
        leaves = len(warm.grids)
        pairs = tree_leaves(engine, q)
        want = torch.cat([tree_plain(m, rg)[: rg.block.n_series] for m, rg in pairs])
        got = torch.as_tensor(rows, device=want.device, dtype=want.dtype)
        err = compare(got, want, f"phase10 {grid} {q}", rtol=1e-3)
        require(rows.shape[0] == N_SERIES and np.isfinite(rows).any(), f"{q}: {rows.shape}")
        if q in TREE_ONCE:
            out[q] = {"rung": rung, "leaves": leaves, "cold_ms": cold_s * 1e3,
                      "max_abs_err": err, "launches": leaves if rung != "host" else 0}
            print(f"phase10 {grid} {q!r}: {rung}, {leaves} leaves, {rows.shape[0]} series x "
                  f"{rows.shape[1]} steps; one run {cold_s * 1e3:.1f} ms, one launch a leaf; "
                  f"rows match plain (max_abs_err {err:.3g}); on {card}")
            continue
        if q == TREE_QUERIES[0][0]:
            total = np.nansum(rows.astype(np.float64), axis=0)
            require(np.allclose(total, sum_rate[0], rtol=1e-3),
                    f"{q}: the rows' sum differs from sum(rate)")
        split = host_split(engine, q)
        row = {"rung": rung, "leaves": leaves, "cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3,
               "staging_ms": (cold_s - warm_s) * 1e3, "max_abs_err": err, **split,
               "launches": 2 * leaves if rung != "host" else 0}
        if rung != "host":
            launches = [tree_launch(m, rg) for m, rg in pairs]

            def kernels():
                for launch in launches:
                    launch()

            gpu_sample(f"phase10 {grid} {q!r} before")
            row["kernel_ms"] = cuda_ms(kernels, reps=20)
            row["kernel_ms_back_to_back"] = back_to_back_ms(kernels, reps=20)
            gpu_sample(f"phase10 {grid} {q!r} after")
            row["plain_ms"] = cuda_ms(lambda: [tree_plain(m, rg) for m, rg in pairs], reps=1,
                                      warmup=0)
            row.update(tree_bound(pairs, rung))
            kern = (f"{TREE_KERNELS[rung]} x {leaves} leaves {row['kernel_ms']:.4f} ms (median "
                    f"of 20; {row['kernel_ms_back_to_back']:.4f} ms back to back), bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {row['bound_bytes']} bytes, "
                    f"{row['operations']:.4g} operations), plain {row['plain_ms']:.2f} ms")
        else:
            kern = "no kernel (timestamp stays host f64)"
        print(f"phase10 {grid} {q!r}: {rung}, {leaves} leaves, {rows.shape[0]} series x "
              f"{rows.shape[1]} steps; first {row['cold_ms']:.1f} ms, warm {row['warm_ms']:.1f} "
              f"ms (hit on every leaf, no staging, the same device copies); warm split: plan "
              f"{split['plan_ms']:.2f} ms, execute {split['execute_ms']:.2f} ms (of which label "
              f"strip {split['label_strip_ms']:.2f} ms), D2H of [S, J] {split['d2h_ms']:.2f} "
              f"ms; rows match plain (max_abs_err {err:.3g}); {kern}; on {card}")
        out[q] = row
    return out


# -- phase 10b: classic buckets ----------------------------------------------------

CLASSIC_SETS = 10_000  # label sets x 12 le bounds = 120,000 classic bucket series
CLASSIC_QUERIES = (
    (0.99, "histogram_quantile(0.99, sum by (le) (rate(http_request_latency_bucket[5m])))"),
    (0.9, "histogram_quantile(0.9, sum by (le, zone) (rate(http_request_latency_bucket[5m])))"),
)


def le_label(le: float) -> str:
    return "+Inf" if np.isinf(le) else f"{le:g}"


def build_memstore_classic(n_sets: int):
    """``n_sets`` label sets of bench.py's histograms (the first ``n_sets``
    of ``build_memstore_hist``'s draws, seed 42) as classic bucket series:
    one ``http_request_latency_bucket{le=...}`` counter per bucket, 720
    samples at exactly 10 s on 8 shards; zone z{i % 8}. Returns the store
    and the f64 sums over each zone's series of each bucket's extrapolated
    rate at the query grid (bench.py's oracle, ``cpu_baseline_hist``'s
    windows), [8, J, B]."""
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    rng = np.random.default_rng(HIST_SEED)
    ts = BASE + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
    ms = TimeSeriesMemStore(StoreConfig(max_chunk_size=N_SAMPLES))
    ms.setup(Dataset("prometheus"), range(N_SHARDS))
    lo_c, hi_c, factor = oracle_windows()
    zone_sums = np.zeros((8, len(factor), N_BUCKETS))
    blk = 2_000
    for b0 in range(0, n_sets, blk):
        n = min(blk, n_sets - b0)
        incr = rng.poisson(2.0, size=(n, N_SAMPLES, N_BUCKETS)).astype(np.float64)
        incr[..., -1] = incr.sum(-1)
        hist = np.cumsum(np.cumsum(incr, axis=2), axis=1)
        rng.uniform(0, 5, size=(n, N_SAMPLES))  # bench.py's sums: keep its stream
        rates = (hist[:, hi_c] - hist[:, lo_c]) * factor[None, :, None] / (WINDOW_MS / 1e3)
        for z in range(8):
            zone_sums[z] += np.nansum(rates[(np.arange(b0, b0 + n) % 8) == z], axis=0)
        for i in range(n):
            for b, le in enumerate(HIST_LES):
                tags = {METRIC_TAG: "http_request_latency_bucket", "_ws_": "demo",
                        "_ns_": "App-2", "instance": f"host-{b0 + i}", "zone": f"z{(b0 + i) % 8}",
                        "le": le_label(le)}
                shard = ms.shard("prometheus", shard_for(tags, spread=SPREAD,
                                                         num_shards=N_SHARDS))
                shard.ingest_series(SeriesBatch(PROM_COUNTER, tags, ts, {"count": hist[i, :, b]}))
    return ms, zone_sums


def oracle_windows():
    """bench.py's windows of the query grid on the 10 s grid from BASE:
    the first and last sample of each step's window, and the f64
    extrapolation factor (NaN below two samples)."""
    num_steps = int((END_S - START_S) // STEP_S) + 1
    out_t = np.int64(START_S * 1000) + np.arange(num_steps, dtype=np.int64) * int(STEP_S * 1000)
    t0g = BASE + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
    hi1 = np.searchsorted(t0g, out_t, side="right")
    lo1 = np.searchsorted(t0g, out_t - WINDOW_MS, side="right")
    cnt = hi1 - lo1
    lo_c, hi_c = np.minimum(lo1, N_SAMPLES - 1), np.minimum(hi1 - 1, N_SAMPLES - 1)
    tf, tl = t0g[lo_c] / 1e3, t0g[hi_c] / 1e3
    sampled = tl - tf
    dur_start = tf - (out_t / 1e3 - WINDOW_MS / 1e3)
    dur_end = out_t / 1e3 - tl
    avg_dur = sampled / np.maximum(cnt - 1, 1)
    ds = np.where(dur_start >= avg_dur * 1.1, avg_dur / 2, dur_start)
    de = np.where(dur_end >= avg_dur * 1.1, avg_dur / 2, dur_end)
    return lo_c, hi_c, np.where(cnt >= 2, (sampled + ds + de) / np.maximum(sampled, 1e-30),
                                np.nan)


def oracle_quantile(q: float, bucket_sum: np.ndarray) -> np.ndarray:
    """bench.py's f64 histogram_quantile over [J, B] bucket sums."""
    les = HIST_LES
    total = bucket_sum[:, -1]
    rank = q * total
    meets = bucket_sum >= rank[:, None]
    idx = np.where(meets.any(1), np.argmax(meets, axis=1), len(les) - 1)
    c_hi = np.take_along_axis(bucket_sum, idx[:, None], axis=1)[:, 0]
    c_lo = np.where(idx > 0, np.take_along_axis(bucket_sum, np.maximum(idx - 1, 0)[:, None],
                                                axis=1)[:, 0], 0.0)
    le_lo = np.where(idx > 0, les[np.maximum(idx - 1, 0)], 0.0)
    frac = (rank - c_lo) / np.maximum(c_hi - c_lo, 1e-30)
    val = np.where(idx == len(les) - 1, les[-2], le_lo + (les[idx] - le_lo) * frac)
    return np.where((total > 0) & np.isfinite(total), val, np.nan)


def run_classic(engine, q: str):
    """One classic quantile through the user's entry point, every launch
    count set to 0 just before and read just after: one launch of the
    regular rung (the by-(le, ...) aggregate) and one standalone-quantile
    gather (one bucket scheme), nothing else."""
    import importlib

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in KERNEL_COUNTERS.items()}
    for name, (_, attr) in KERNEL_COUNTERS.items():
        setattr(mods[name], attr, 0)
    t0 = time.perf_counter()
    res = engine.query_range(q, START_S, END_S, STEP_S)
    vals = res.grids[0].values_np()
    wall = time.perf_counter() - t0
    counts = {name: getattr(mods[name], attr) for name, (_, attr) in KERNEL_COUNTERS.items()}
    want = {k: int(k in ("regular_range", "hist_quantile_gather")) for k in KERNEL_COUNTERS}
    require(counts == want, f"{q}: launches {counts}, expected {want}")
    return res, vals, wall


def phase_classic(device, card: str) -> dict:
    """Phase 10b: ``CLASSIC_QUERIES`` over 10,000 label sets x 12 le
    bounds (``build_memstore_classic``), each cold then warm: one aggregate
    launch plus one gather per scheme; [G, J] against the plain fold of the
    same aggregate (rtol 1e-3) and bench.py's f64 oracle (rtol 5e-3); the
    gather's ms beside its bound and the plain fold's ms."""
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.query.exec.transformers import classic_pivot

    t0 = time.perf_counter()
    ms, zone_sums = build_memstore_classic(CLASSIC_SETS)
    print(f"phase10b ingest: {CLASSIC_SETS} label sets x {N_BUCKETS} le bounds = "
          f"{CLASSIC_SETS * N_BUCKETS} classic bucket series x {N_SAMPLES} samples on "
          f"{N_SHARDS} shards in {time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    out = {}
    for q, query in CLASSIC_QUERIES:
        cold_cache(engine)
        cold, cold_vals, cold_s = run_classic(engine, query)
        warm, vals, warm_s = run_classic(engine, query)
        require(warm.stats.cache_hits == 1 and warm.stats.cache_misses == 0,
                f"{query}: the warm run must hit the superblock, stats {warm.stats}")
        labels = warm.grids[0].labels
        ex = exec_node(engine, query)
        entry = ex.superblock(engine.context())
        gids, G, params = path_args(entry, ex)
        agg = AGG.fused_range_aggregate(ex.function, ex.op, entry.block, gids, G, params,
                                        is_counter=entry.is_counter, is_delta=entry.is_delta)
        _, group_labels = AGG.group_ids_memo(entry.block, entry.labels, ex.by, ex.without,
                                             strip_metric=True)[1:]
        pivot = classic_pivot(group_labels, agg.device)
        J = ex.num_steps()
        plain = torch.full((len(pivot.labels), agg.shape[1]), float("nan"), device=agg.device)
        for table, rws, les in pivot.schemes:
            plain[rws.long(), :J] = HK.histogram_quantile_gather_plain(q, agg, table, les, J)
        got = torch.as_tensor(vals, device=agg.device)
        err = compare(got, plain[:, :J], f"phase10b {query} vs the plain fold", rtol=1e-3)
        if ex.by == ("le",):
            want = oracle_quantile(q, zone_sums.sum(0))[None, :]
        else:
            want = np.stack([oracle_quantile(q, zone_sums[int(l["zone"][1:])]) for l in labels])
        oracle_err = compare(got.double(), torch.as_tensor(want, device=agg.device),
                             f"phase10b {query} vs bench.py's f64 oracle", rtol=5e-3)
        require(np.isfinite(vals).all(), f"{query}: non-finite quantiles")
        (table, rws, les), = pivot.schemes
        buf = torch.full_like(plain, float("nan"))

        def gather():
            HK.histogram_quantile_gather(q, agg, table, rws, les, J, buf)

        def empty():
            HK.empty_launch(Gq, J, agg.device)

        Gq, B = table.shape
        k_ms = cuda_ms(gather, reps=20)
        k_b2b = back_to_back_ms(gather)
        k_graph = graph_ms(gather)
        k_host = host_ms(gather)
        floor_graph = graph_ms(empty)
        p_ms = cuda_ms(lambda: HK.histogram_quantile_gather_plain(q, agg, table, les, J), reps=20)
        need = Gq * B * J * 4 + Gq * J * 4 + Gq * B * 4 + Gq * 4 + B * 4
        bound_ms = need / HBM_BYTES_PER_S * 1e3
        print(f"phase10b {query!r}: {G} by-(le, ...) groups -> {len(labels)} quantile rows x "
              f"{J} steps; cold {cold_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms; one "
              f"regular_range launch plus one hist_quantile_gather launch (1 scheme) each; "
              f"matches the plain fold (max_abs_err {err:.3g}) and bench.py's f64 oracle "
              f"(max_abs_err {oracle_err:.3g}, rtol 5e-3); gather {k_ms:.4f} ms a call between "
              f"events (median of 20), {k_b2b:.4f} ms back to back, {k_graph:.5f} ms on the "
              f"device (CUDA graph replay), host enqueue {k_host:.4f} ms a call; an empty "
              f"kernel over the same blocks {floor_graph:.5f} ms on the device (graph replay); "
              f"bound {bound_ms:.6f} ms ({need} bytes), plain {p_ms:.4f} ms; on {card}")
        out[query] = {"cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3, "groups": G,
                      "rows": len(labels), "max_abs_err": err, "oracle_max_abs_err": oracle_err,
                      "kernel_ms": k_ms, "kernel_ms_back_to_back": k_b2b,
                      "kernel_device_ms": k_graph, "host_enqueue_ms": k_host,
                      "empty_launch_device_ms": floor_graph, "plain_ms": p_ms,
                      "bound_ms": bound_ms, "bound_bytes": need, "aggregate_launches": 2,
                      "gather_launches": 2}
    return out


# -- phase 10c: time slicing ---------------------------------------------------------

MONTH_SERIES, MONTH_SAMPLE_MS, DAY_MS = 1_000, 300_000, 86_400_000
MONTH_RANGE = ((BASE + 2 * 3_600_000) / 1000, (BASE + 30 * DAY_MS - 3_600_000) / 1000, 3_600.0)
MONTH_QUERIES = ("sum(rate(http_requests_total[1h]))", "rate(http_requests_total[1h])")


def plain_of(plan, ctx) -> dict:
    """The plan's rows through the plain versions on the card, by labels:
    a StitchRvsExec's slices stitched in time, a DistConcatExec's leaves,
    a leaf's rows, a fused aggregate's [G, J]."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps
    from filodb_tpu_torch.query.exec import plans as P
    from filodb_tpu_torch.query.exec.transformers import _strip_metric

    if isinstance(plan, P.StitchRvsExec):
        parts = [(c, plain_of(c, ctx)) for c in plan.children()]
        step = parts[0][0].step_ms if isinstance(parts[0][0], P.FusedAggregateExec) else \
            parts[0][0].children()[0].transformers[0].step_ms
        starts = [c.start_ms if isinstance(c, P.FusedAggregateExec)
                  else c.children()[0].transformers[0].start_ms for c, _ in parts]
        ends = [c.end_ms if isinstance(c, P.FusedAggregateExec)
                else c.children()[0].transformers[0].end_ms for c, _ in parts]
        n = (max(ends) - min(starts)) // step + 1
        out: dict = {}
        for (c, rows), s0 in zip(parts, starts):
            off = (s0 - min(starts)) // step
            for k, v in rows.items():
                row = out.setdefault(k, np.full(n, np.nan))
                row[off: off + len(v)] = np.where(np.isnan(row[off: off + len(v)]), v,
                                                  row[off: off + len(v)])
        return out
    if isinstance(plan, P.DistConcatExec):
        out = {}
        for c in plan.children():
            out.update(plain_of(c, ctx))
        return out
    if isinstance(plan, P.SelectRawPartitionsExec):
        out = {}
        for rg in plan.do_execute(ctx).raw_grids:
            mapper = plan.transformers[0]
            vals = tree_plain(mapper, rg)[: rg.block.n_series].double().cpu().numpy()
            for l, v in zip(rg.labels, vals):
                out[tuple(sorted(_strip_metric(l).items()))] = v
        return out
    entry = plan.superblock(ctx)
    b = entry.block
    gids, G, params = path_args(entry, plan)
    if b.regular_ts is not None:
        wm = MK.window_matrices(b, int(params.start_ms - b.base_ms), params.step_ms,
                                pad_steps(params.num_steps), params.window_ms)
        raw = b.raw if b.raw is not None else b.vals
        sj = MK.mxu_range_plain(plan.function, b.vals, raw, wm, params.window_ms,
                                is_counter=entry.is_counter, is_delta=entry.is_delta)
        g = AGG.apply_epilogue(sj, ("agg", plan.op), gids, G)
    else:
        g = WS.window_range_aggregate_plain(plan.function, plan.op, b, gids, G, params,
                                            is_counter=entry.is_counter, is_delta=entry.is_delta)
    _, _, labels = AGG.group_ids_memo(entry.block, entry.labels, plan.by, plan.without,
                                      strip_metric=True)
    vals = g[:, : plan.num_steps()].double().cpu().numpy()
    return {tuple(sorted(l.items())): v for l, v in zip(labels, vals)}


def phase_month(device, card: str) -> dict:
    """Phase 10c: 1,000 counters at one sample per 5 min over 30 days (more
    than a staged block's int32 ms span): ``MONTH_QUERIES`` over the whole
    range at 1 h steps plan a ``StitchRvsExec`` of two time slices and equal
    the plain path on the card (rtol 1e-3, NaN masks equal)."""
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.query.exec import plans as P
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    rng = np.random.default_rng(17)
    n = 30 * DAY_MS // MONTH_SAMPLE_MS
    ts = BASE + np.arange(n, dtype=np.int64) * MONTH_SAMPLE_MS
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("prometheus"), range(N_SHARDS))
    for i in range(MONTH_SERIES):
        tags = series_tags(i)
        ms.shard("prometheus", shard_for(tags, spread=SPREAD, num_shards=N_SHARDS)).ingest_series(
            SeriesBatch(PROM_COUNTER, tags, ts, {"count": np.cumsum(rng.uniform(0, 10, n)) + 1e6}))
    engine = QueryEngine(ms, "prometheus")
    start, end, step = MONTH_RANGE
    out = {}
    for q in MONTH_QUERIES:
        plan = engine.planner.materialize(query_range_to_logical_plan(q, start, end, step))
        require(isinstance(plan, P.StitchRvsExec) and len(plan.children()) == 2,
                f"{q}: planned {type(plan).__name__}, not two stitched slices")
        t0 = time.perf_counter()
        res = engine.query_range(q, start, end, step)
        got = {tuple(sorted(l.items())): v for g in res.grids
               for l, v in zip(g.labels, g.values_np())}
        wall = time.perf_counter() - t0
        want = plain_of(plan, engine.context())
        require(sorted(got) == sorted(want), f"{q}: labels differ from the plain path")
        err = max(compare(torch.as_tensor(got[k], dtype=torch.float64),
                          torch.as_tensor(want[k]), f"phase10c {q}", rtol=1e-3) for k in want)
        steps = len(next(iter(got.values())))
        require(all(np.isfinite(v).mean() > 0.99 for v in got.values()), f"{q}: gaps")
        print(f"phase10c {q!r}: 30 days at {int(step)} s steps ({steps} steps) as a "
              f"StitchRvsExec of 2 slices ({', '.join(type(c).__name__ for c in plan.children())}),"
              f" {len(got)} rows in {wall * 1e3:.1f} ms (cold); equals the plain path "
              f"(max_abs_err {err:.3g}); on {card}")
        out[q] = {"rows": len(got), "steps": steps, "cold_ms": wall * 1e3, "max_abs_err": err}
    return out



# -- phase 2e: the tree's aggregate kernels against their plain versions --------------

AGG_TREE_GROUPS = ("one", "eight", "each", "past_shared")  # phase 2e's groupings
LEAF_SERIES = N_SERIES // N_SHARDS  # a shard leaf's series: K2's step route
TOPK_KS = (1, 3, 16, 32, 33, 1000)  # phase 2e's k: the step route up to 16, the per-group one past it


def agg_tree_block(kind: str, S: int, J: int, seed: int, device):
    """Phase 2e's [S, J] values: rate-like to three decimals (ties), 2 % NaN
    and, for ``special``, +-inf and signed zeros; the transposed view of a
    step-major [J + 1, S + 3] grid on the card, as a tree leaf holds it."""
    import torch

    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(0, 10, (J, S)), 3).astype(np.float32)
    if kind == "special":
        for x, p in ((np.inf, 0.005), (-np.inf, 0.005), (0.0, 0.02), (-0.0, 0.02)):
            v[rng.random((J, S)) < p] = x
    v[rng.random((J, S)) < 0.02] = np.nan
    big = np.full((J + 1, S + 3), np.nan, np.float32)
    big[:J, :S] = v
    return torch.from_numpy(big).to(device).T[:S, :J]


def agg_tree_gids(groups: str, S: int, seed: int) -> np.ndarray:
    """G = 1, 8 interleaved (bench.py's zones), S groups of one, and 3000
    groups of random sizes (past K1's shared-memory budget: global
    atomics; K2's large groups on clusters, the rest a thread each)."""
    rng = np.random.default_rng(seed)
    return {"one": np.zeros(S, np.int64), "eight": np.arange(S) % 8, "each": np.arange(S),
            "past_shared": rng.integers(0, 3000, S)}[groups]


def phase_tree_aggregates_vs_plain(seed: int, device, S: int = N_SERIES, J: int = 111) -> dict:
    """Phase 2e: the segment aggregate (K1, ``csrc/segment_agg.cu``) and the
    grouped top-k (K2, ``filodb_segment_topk``) against their plain versions
    on the card, on seeded [S, J] blocks read in place (step-major) in each
    grouping of ``AGG_TREE_GROUPS`` (2 % NaN; ties; +-inf and signed zeros
    in the ``special`` blocks): K1's count, min, max and group bit-equal,
    sum and sumsq within rtol 1e-4 (another order), NaN masks equal; K2 at
    each k of ``TOPK_KS``, topk and bottomk, over S series (the per-group
    route: a cluster per (large group, step)) and over a shard leaf's
    ``LEAF_SERIES`` (the step route: every group of a step in one block):
    kept values and thresholds bit-equal, their largest absolute
    difference measured."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import order_stats as OS
    from filodb_tpu_torch.ops import segment_agg as SA

    k1_err, k1_cases, k2_cases, routes = 0.0, 0, 0, set()
    for b, kind in enumerate(("normal", "special")):
        v = agg_tree_block(kind, S, J, seed + b, device)
        for groups in AGG_TREE_GROUPS:
            gids_np = agg_tree_gids(groups, S, seed)
            G = int(gids_np.max()) + 1
            gids = torch.from_numpy(gids_np).to(device)
            got = SA.segment_components(v, gids, G, SA.COMPONENTS)
            for c in SA.COMPONENTS:
                want = AGG.segment_aggregate(c, v, gids, G)
                what = f"2e segment_aggregate {c} {kind} {groups}"
                if c in ("sum", "sumsq"):
                    k1_err = max(k1_err, compare(got[c], want, what, rtol=1e-4))
                else:
                    require(torch.equal(torch.isnan(got[c]), torch.isnan(want)) and torch.equal(
                        got[c].view(torch.int32)[~torch.isnan(want)],
                        want.view(torch.int32)[~torch.isnan(want)]), f"{what}: differs")
            k1_cases += 1
    k2_err = 0.0
    for n in (S, LEAF_SERIES):  # a shard's width: the step route; 100k: the per-group route
        for b, kind in enumerate(("normal", "special")):
            grid = SA.step_major(agg_tree_block(kind, n, J, seed + b, device))
            for groups in AGG_TREE_GROUPS:
                gids_np = agg_tree_gids(groups, n, seed)
                members = OS.segment_members(torch.from_numpy(gids_np).to(device),
                                             int(gids_np.max()) + 1)
                for k in TOPK_KS:
                    for bottom in (False, True):
                        out, thr = OS.segment_topk(grid, members, k, bottom)
                        routes.add(OS.LAST_PLAN.route)
                        w_out, w_thr = OS.segment_topk_plain(grid, members, k, bottom)
                        what = f"2e segment_topk {kind} {groups} n={n} k={k} bottom={bottom}"
                        require(torch.equal(out.view(torch.int32), w_out.view(torch.int32))
                                and torch.equal(thr.view(torch.int32), w_thr.view(torch.int32)),
                                f"{what}: differs from plain")
                        k2_err = max(k2_err, abs_gap(out, w_out), abs_gap(thr, w_thr))
                        k2_cases += 1
    torch.cuda.synchronize()
    print(f"phase2e segment_aggregate ({k1_cases} blocks of {S} x {J}: G = 1, 8, {S}, 3000) "
          f"count/min/max/group bit-equal to plain, sum/sumsq within rtol 1e-4 (max_abs_err "
          f"{k1_err:.3g}); segment_topk ({k2_cases} cases over {S} and {LEAF_SERIES} series, "
          f"k in {', '.join(map(str, TOPK_KS))}, routes {sorted(routes)}) bit-equal to plain "
          f"(max_abs_err {k2_err})")
    return {"segment_aggregate_max_abs_err": k1_err, "segment_aggregate_blocks": k1_cases,
            "segment_topk_cases": k2_cases, "segment_topk_routes": sorted(routes),
            "segment_topk_max_abs_err": k2_err}


# -- phase 11: the tree's aggregates, operators and instant functions -----------------

AT_S = int(END_S)
# (query, the stores it runs on): every query on the irregular store (the
# window-stats, general and sorted rungs under the tree), and on the
# regular store (the regular rung's store mode) the two that feed K1 and
# K2 and count_values; each cold query restages the shards (5-9 s on the
# card's host), so running all of them on both stores took the script
# past 1000 s
TREE_AGG_QUERIES = (
    ("stddev(rate(http_requests_total[5m]))", ("irregular", "regular")),
    ("stdvar by (zone) (rate(http_requests_total[5m]))", ("irregular",)),
    ("group by (zone) (http_requests_total)", ("irregular",)),
    ("sum(quantile_over_time(0.5, http_requests_total[5m]))", ("irregular",)),
    (f"sum(rate(http_requests_total[5m] @ {AT_S}))", ("irregular",)),
    ("topk by (zone) (3, rate(http_requests_total[5m]))", ("irregular", "regular")),
    ("quantile(0.9, abs(rate(http_requests_total[5m])))", ("irregular",)),
    ('count_values("c", changes(http_requests_total[5m]))', ("regular",)),
    ("rate(http_requests_total[5m]) * 2", ("irregular",)),
    ("rate(http_requests_total[5m]) > bool 0.1", ("irregular",)),
    ("rate(http_requests_total[5m]) / irate(http_requests_total[5m])", ("irregular",)),
    ("rate(http_requests_total[5m]) / on (zone) group_left "
     "sum by (zone) (rate(http_requests_total[5m]))", ("irregular",)),
)
# run once, not first then warm (each on the caches its predecessors left):
# the script's time
TREE_AGG_ONCE = frozenset({
    "stdvar by (zone) (rate(http_requests_total[5m]))",
    f"sum(rate(http_requests_total[5m] @ {AT_S}))",
    "rate(http_requests_total[5m]) * 2",
    "rate(http_requests_total[5m]) > bool 0.1",
})
# with fused_aggregate=False, held against the fused answer (irregular store)
UNFUSED_QUERY = "sum by (zone) (rate(http_requests_total[5m]))"
RUNG_COUNTERS = ("window_range", "general_range", "regular_range", "sorted_window",
                 "jitter_range", "masked_range")
TREE_AGG_COUNTERS = dict(KERNEL_COUNTERS, segment_agg=("segment_agg", "LAUNCHES"))


def expected_launches(plan) -> dict:
    """The launches a tree plan makes: a rung per leaf with a range
    function and per fused aggregate; K1 per map phase (a leaf's
    ``AggregateMapReduce``, or a root over a subtree); K2 per candidate
    filter and per topk/bottomk root; one quantile per quantile root."""
    from filodb_tpu_torch.query.exec import plans as P
    from filodb_tpu_torch.query.exec import transformers as TR

    want = {"rungs": 0, "segment_agg": 0, "segment_topk": 0, "segment_quantile": 0}

    def walk(node):
        if isinstance(node, (P.SelectRawPartitionsExec, P.FusedAggregateExec)):
            want["rungs"] += 1
        for tr in node.transformers:
            if isinstance(tr, P.AggregateMapReduce):
                want["segment_agg"] += 1
            elif isinstance(tr, TR.TopkCandidateFilter):
                want["segment_topk"] += 1
        if isinstance(node, P.AggregatePresentExec):
            if node.op in P._PARTIAL_COMPONENTS:
                want["segment_agg"] += 1
            elif node.op in ("topk", "bottomk"):
                want["segment_topk"] += 1
            elif node.op == "quantile":
                want["segment_quantile"] += 1
        for c in node.children():
            walk(c)

    walk(plan)
    return want


def run_tree_agg(engine, q: str):
    """One phase-11 query through the user's entry point, every launch
    count set to 0 just before and read just after: each leaf one rung
    launch, the map phases and roots their K1/K2/quantile launches
    (``expected_launches``), no other kernel. Returns the result, its rows
    by labels, the end-to-end seconds and the counts with the host split
    (``plan_ms``: planning it alone; ``execute_ms``: the engine's call to
    the card's last kernel; ``rows_ms``: the rows to the host by labels,
    the D2H included)."""
    import importlib

    import torch

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in TREE_AGG_COUNTERS.items()}
    t0 = time.perf_counter()
    want = expected_launches(exec_node(engine, q))
    plan_ms = (time.perf_counter() - t0) * 1e3
    for name, (_, attr) in TREE_AGG_COUNTERS.items():
        setattr(mods[name], attr, 0)
    t0 = time.perf_counter()
    res = engine.query_range(q, START_S, END_S, STEP_S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows = {tuple(sorted(l.items())): v for g in res.grids
            for l, v in zip(g.labels, g.values_np())}
    wall = time.perf_counter() - t0
    counts = {name: getattr(mods[name], attr) for name, (_, attr) in TREE_AGG_COUNTERS.items()}
    got = {"rungs": sum(counts[k] for k in RUNG_COUNTERS), "segment_agg": counts["segment_agg"],
           "order_stats": counts["order_stats"]}
    need = {"rungs": want["rungs"], "segment_agg": want["segment_agg"],
            "order_stats": want["segment_topk"] + want["segment_quantile"]}
    require(got == need, f"{q}: launches {counts}, expected {need}")
    others = {k: v for k, v in counts.items()
              if k not in RUNG_COUNTERS and k not in ("segment_agg", "order_stats") and v}
    require(not others, f"{q}: other kernels launched: {others}")
    split = {"plan_ms": plan_ms, "execute_ms": (t1 - t0) * 1e3,
             "rows_ms": (wall - (t1 - t0)) * 1e3}
    return res, rows, wall, {**counts, **want, **split}


def plain_dispatch(func, block, params, is_counter=False, is_delta=False, args=()):
    """``kernels._dispatch_range_function`` through the plain versions, on
    the card: (the [S, J] values, the variant)."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import kernels as K
    from filodb_tpu_torch.ops import sorted_window as SW

    J, start_off = params.num_steps, int(params.start_ms - block.base_ms)
    variant = K.tree_rung(func, block, params, is_delta, args)
    if variant == "host":
        return K._host_timestamp(block, params), "host"
    if variant == "sorted":
        q, a1 = SW.func_args(args)
        return SW.sorted_window_plain(func, block.ts, block.vals, block.lens, start_off,
                                      params.step_ms, params.window_ms, J, q, a1), "sorted"
    return AGG.rung_series_plain(variant, func, block, params, is_counter, is_delta,
                                 args), variant


def plain_fused(func, op, block, gids, G, params, is_counter=False, is_delta=False, obs=None):
    """``aggregations.fused_range_aggregate`` through the plain versions."""
    from filodb_tpu_torch.ops import aggregations as AGG

    variant = AGG.grid_variant(block, func, is_delta, params.window_ms)
    if obs is not None:
        obs["variant"] = variant
    sj = AGG.rung_series_plain(variant, func, block, params, is_counter, is_delta)
    return AGG.apply_epilogue(sj, ("agg", op), gids, G)


class plain_kernels:
    """Within it, the engine runs its rungs, K1, K2 and the quantile
    through their plain versions (on the card's tensors)."""

    def __enter__(self):
        from filodb_tpu_torch.ops import aggregations as AGG
        from filodb_tpu_torch.ops import kernels as K
        from filodb_tpu_torch.ops import order_stats as OS
        from filodb_tpu_torch.ops import segment_agg as SA

        def components(values, gids, G, comps, lib=None):
            return {c: AGG.segment_aggregate(c, values, gids.long(), G) for c in comps}

        def topk(grid, members, k, bottom=False, plan=None, lib=None):
            return OS.segment_topk_plain(grid, members, k, bottom)

        def quantile(grid, members, q, plan=None, lib=None):
            return OS.segment_quantile_plain(grid, members, q)

        self.saved = [(K, "_dispatch_range_function"), (AGG, "fused_range_aggregate"),
                      (SA, "segment_components"), (OS, "segment_topk"),
                      (OS, "segment_quantile")]
        self.saved = [(m, a, getattr(m, a)) for m, a in self.saved]
        for (m, a, _), f in zip(self.saved, (plain_dispatch, plain_fused, components, topk,
                                             quantile)):
            setattr(m, a, f)
        return self

    def __exit__(self, *exc):
        for m, a, f in self.saved:
            setattr(m, a, f)
        return False


def rows_match(got: dict, want: dict, what: str, rtol: float = 1e-3) -> float:
    """Labels equal, NaN masks equal, values within rtol; the largest
    absolute difference."""
    require(sorted(got) == sorted(want), f"{what}: labels differ from the plain path "
            f"({len(got)} vs {len(want)} rows)")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        require(np.array_equal(np.isnan(g), np.isnan(w)), f"{what}: NaN masks differ at {k}")
        m = ~np.isnan(w)
        require(np.allclose(g[m], w[m], rtol=rtol), f"{what}: values differ at {k}")
        fin = m & np.isfinite(w)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(g[fin].astype(np.float64) - w[fin]))))
    return worst


def grouped_winners_match(got: dict, want: dict, group: str, what: str) -> int:
    """topk by (group) against the plain path: per group phase 9's rule
    (``winners_match``: the same winners except at near ties). Returns
    the near ties."""
    ties = 0
    for z in sorted({dict(k)[group] for k in want}):
        g = {k: v for k, v in got.items() if dict(k)[group] == z}
        w = {k: v for k, v in want.items() if dict(k)[group] == z}
        ties += winners_match([dict(k) for k in g], np.stack(list(g.values())),
                              [dict(k) for k in w], np.stack(list(w.values())), False, 1e-3,
                              f"{what} {group}={z}")
    return ties


def bool_rows_match(got: dict, want: dict, rate: dict, threshold: float, what: str) -> int:
    """``rate > bool x`` against the plain path: a 0/1 that differs only
    where the plain rate lies within rtol 1e-3 of x. Returns those flips."""
    require(sorted(got) == sorted(want), f"{what}: labels differ from the plain path")
    flips = 0
    for k, w in want.items():
        g = got[k]
        require(np.array_equal(np.isnan(g), np.isnan(w)), f"{what}: NaN masks differ at {k}")
        d = ~np.isnan(w) & (g != w)
        require(np.allclose(rate[k][d], threshold, rtol=1e-3),
                f"{what}: a comparison differs away from the threshold at {k}")
        flips += int(d.sum())
    return flips


def check_tree_agg(engine, q: str, rows: dict, grid: str) -> dict:
    """Phase 11's answer against the plain path on the card, by labels."""
    with plain_kernels():
        want = {tuple(sorted(l.items())): v for g in engine.query_range(
            q, START_S, END_S, STEP_S).grids for l, v in zip(g.labels, g.values_np())}
        rate = None
        if " > bool " in q:
            base = q.split(" > bool ")[0]
            rate = {tuple(sorted(l.items())): v for g in engine.query_range(
                base, START_S, END_S, STEP_S).grids for l, v in zip(g.labels, g.values_np())}
    what = f"phase11 {grid} {q}"
    require(want and all(np.isfinite(v).any() for v in rows.values()),
            f"{what}: an empty or all-NaN answer")
    if q.startswith("topk by (zone)"):
        return {"near_ties": grouped_winners_match(rows, want, "zone", what)}
    if rate is not None:
        return {"near_threshold_flips": bool_rows_match(rows, want, rate,
                                                        float(q.split(" > bool ")[1]), what)}
    return {"max_abs_err": rows_match(rows, want, what)}


def phase_tree_aggregates(engine, card: str, grid: str) -> dict:
    """Phase 11: ``TREE_AGG_QUERIES`` on a 100k-series store (phase 4's
    irregular or phase 5's regular one: the queries listed for it), and on
    the irregular one ``UNFUSED_QUERY`` with ``fused_aggregate=False``:
    each through ``QueryEngine`` first (the phase's first query on fresh
    caches; the later ones on the caches their predecessors left, a miss
    where their staging is new: the cold repeats were cut to keep the
    script's time, as in phase 10) then warm (``TREE_AGG_ONCE``: the
    first run alone), with its launches checked
    (``run_tree_agg``), the warm rows equal to the first ones (rtol 1e-3)
    and to the plain path on
    the card (``check_tree_agg``: rtol 1e-3, NaN masks equal; topk winner
    sets equal except at near ties; a comparison's 0/1 equal except where
    the plain rate is within rtol 1e-3 of the threshold); the unfused
    answer equal to the fused one (rtol 1e-3). Prints cold and warm ms and
    the warm run's host split."""
    from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine

    out = {}
    unfused = QueryEngine(engine.memstore, engine.dataset,
                          params=PlannerParams(fused_aggregate=False))
    runs = [(q, engine) for q, stores in TREE_AGG_QUERIES if grid in stores]
    if grid == "irregular":
        runs.append((UNFUSED_QUERY, unfused))
    for i, (q, eng) in enumerate(runs):
        if i == 0:
            cold_cache(eng)
        first = run_tree_agg(eng, q)
        _, cold_rows, cold_s, _ = first
        res, rows, warm_s, counts = first if q in TREE_AGG_ONCE else run_tree_agg(eng, q)
        require(sorted(rows) == sorted(cold_rows) and all(
            np.allclose(rows[k], cold_rows[k], rtol=1e-3, equal_nan=True) for k in rows),
            f"{q}: warm differs from cold")
        split = {k: counts.pop(k) for k in ("plan_ms", "execute_ms", "rows_ms")}
        row = {"cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3, "rows": len(rows),
               "launches": counts, **check_tree_agg(eng, q, rows, grid), **split}
        if eng is unfused:
            fused = {tuple(sorted(l.items())): v for g in engine.query_range(
                q, START_S, END_S, STEP_S).grids for l, v in zip(g.labels, g.values_np())}
            row["vs_fused_max_abs_err"] = rows_match(rows, fused, f"phase11 {grid} unfused {q}")
            q = f"{q} [fused_aggregate=False]"
        runs_s = (f"one run {row['warm_ms']:.1f} ms (split" if q in TREE_AGG_ONCE else
                  f"cold {row['cold_ms']:.1f} ms, warm {row['warm_ms']:.1f} ms (warm split")
        print(f"phase11 {grid} {q!r}: {row['rows']} rows; {runs_s}: plan {row['plan_ms']:.2f}, execute "
              f"{row['execute_ms']:.2f}, rows to the host {row['rows_ms']:.2f} ms); launches "
              f"{ {k: v for k, v in counts.items() if v} }; matches the plain path "
              f"({ {k: v for k, v in row.items() if k in ('max_abs_err', 'near_ties', 'near_threshold_flips', 'vs_fused_max_abs_err')} }); "
              f"on {card}")
        out[q] = row
    return out


def tree_agg_kernels(engine, card: str, grid: str) -> dict:
    """K1 and K2 timed at phase 11's shapes on ``grid``'s store: K1 over
    ``stddev(rate)``'s 8 leaves (G = 1, three components) and
    ``stdvar by (zone)``'s (G = 8); K2 over ``topk by (zone) (3, rate)``'s
    8 leaf filters (G = 8 each), also on the device alone
    (``torch.profiler``: back to back, the launches are shorter than their
    host enqueue) and on both its routes alternating; each all leaves'
    launches together (median of 20 calls, and back to back), beside the bound (the
    grid read once, the outputs written once, 3.35 TB/s), the plain
    versions' ms and the library line: ``index_add_`` of the sum component
    (K1), none for a grouped top-k (``torch.topk`` at G = 1 over the same
    leaves' grids printed as a reference)."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import order_stats as OS
    from filodb_tpu_torch.ops import segment_agg as SA
    from filodb_tpu_torch.query.exec.transformers import grid_members

    rate_q = "rate(http_requests_total[5m])"
    grids = engine.query_range(rate_q, START_S, END_S, STEP_S).grids  # one per leaf
    out = {}
    for name, by, comps in (("stddev", None, ("sum", "sumsq", "count")),
                            ("stdvar by (zone)", ["zone"], ("sum", "sumsq", "count"))):
        leaves = []
        for g in grids:
            v = g.values[: g.n_series, : g.num_steps]
            members, G, _, gids = grid_members(g, by, None, v.device)
            leaves.append((v, gids, G))
        need = sum((v.numel() + len(comps) * G * v.shape[1]) * 4 + v.shape[0] * 4
                   for v, _, G in leaves)

        def k1():
            for v, gids, G in leaves:
                SA.segment_components(v, gids, G, comps)

        def k1_plain():
            for v, gids, G in leaves:
                for c in comps:
                    AGG.segment_aggregate(c, v, gids, G)

        v0 = [(torch.nan_to_num(v.contiguous(), nan=0.0), gids,
               torch.zeros((G, v.shape[1]), device=v.device)) for v, gids, G in leaves]

        def library():
            for v, gids, acc in v0:
                acc.index_add_(0, gids, v)

        out[f"segment_aggregate {name}"] = {
            "ms": cuda_ms(k1, reps=20), "ms_back_to_back": back_to_back_ms(k1, reps=20),
            "plain_ms": cuda_ms(k1_plain, reps=3, warmup=1),
            "library_ms": back_to_back_ms(library, reps=20),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bound_bytes": need,
            "leaves": len(leaves), "groups": leaves[0][2]}
    leaves = []
    for g in grids:
        v = g.values[: g.n_series, : g.num_steps]
        members, G, _, gids = grid_members(g, ["zone"], None, v.device)
        leaves.append((SA.step_major(v), members))
    need = sum(grid.numel() * 8 + grid.shape[1] * 4 + m.starts.numel() * 4
               + m.num_groups * grid.shape[0] * 4 for grid, m in leaves)

    def k2(by_step=None):
        for grid, m in leaves:
            plan = OS.order_plan("segment_topk", m, grid.shape[0], by_step=by_step, k=3)
            OS.segment_topk(grid, m, 3, plan=plan)

    def k2_plain():
        for grid, m in leaves:
            OS.segment_topk_plain(grid, m, 3)

    def topk_g1():
        for grid, _ in leaves:
            torch.topk(grid, 3, dim=1)

    k2()
    route = OS.LAST_PLAN.route
    # the per-group route (the design the step route replaced, the same
    # build) beside it, alternating: group, step, step, group
    alt = {"group": [], "step": []}
    for by_step in (False, True, True, False):
        name = "step" if by_step else "group"
        alt[name].append({"ms_back_to_back": back_to_back_ms(lambda: k2(by_step), reps=20),
                          "device_ms": device_ms(lambda: k2(by_step), "segment_topk")})
    out["segment_topk by (zone) (3)"] = {
        "ms": cuda_ms(k2, reps=20), "ms_back_to_back": back_to_back_ms(k2, reps=20),
        "device_ms": device_ms(k2, "segment_topk"), "routes_alternating": alt,
        "plain_ms": cuda_ms(k2_plain, reps=3, warmup=1), "library_ms": None,
        "torch_topk_g1_ms": back_to_back_ms(topk_g1, reps=20), "route": route,
        "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bound_bytes": need, "leaves": len(leaves)}
    for name, r in out.items():
        lib = (f"index_add_ of the sum {r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"no library call for a grouped top-k (torch.topk at G = 1 over the same "
                    f"grids {r['torch_topk_g1_ms']:.4f} ms)")
        dev = f", device {r['device_ms']:.4f} ms" if "device_ms" in r else ""
        print(f"phase11 {grid} kernel {name} x {r['leaves']} leaves: {r['ms']:.4f} ms (median of "
              f"20; {r['ms_back_to_back']:.4f} ms back to back{dev}), bound {r['bound_ms']:.4f} "
              f"ms (bytes: {r['bound_bytes']}), plain {r['plain_ms']:.3f} ms, {lib}; on {card}")
    alt = out["segment_topk by (zone) (3)"]["routes_alternating"]
    print(f"phase11 {grid} segment_topk by route, alternating group, step, step, group: " + "; ".join(
        f"{k} back to back {[round(x['ms_back_to_back'], 4) for x in v]} ms, device "
        f"{[round(x['device_ms'], 4) for x in v]} ms" for k, v in alt.items()))
    return out


def tree_agg_rows(tree_agg: dict, kernels: dict, phase2e: dict, rung_rows: dict,
                  other_rows: list) -> list:
    """The kernels line's rows of K1 and K2, timed at phase 11's irregular
    store; phase 11's launches of the rungs, sorted_window and
    segment_quantile go to their rows."""
    seg_launches = topk_launches = quantile_launches = sorted_launches = 0
    for per_store in tree_agg.values():
        for q, row in per_store.items():
            c = row["launches"]
            seg_launches += 2 * c["segment_agg"]  # cold and warm
            topk_launches += 2 * c["segment_topk"]
            quantile_launches += 2 * c["segment_quantile"]
            sorted_launches += 2 * c["sorted_window"]
            for counter, key in (("window_range", "window_stats"), ("regular_range", "mxu"),
                                 ("general_range", "general")):
                rung_rows[key]["launches"] += 2 * c[counter]
    for r in other_rows:
        r["launches"] += {"segment_quantile": quantile_launches,
                          "sorted_window": sorted_launches}.get(r["name"], 0)
    k1, k2 = kernels["segment_aggregate stddev"], kernels["segment_topk by (zone) (3)"]
    errs = [r.get("max_abs_err", 0.0) for per in tree_agg.values() for r in per.values()]
    return [{
        "name": "segment_aggregate", "route": "cuda",
        "source": "filodb_tpu_torch/csrc/segment_agg.cu",
        "replaces": "filodb_tpu/ops/aggregations.py:49", "launches": seg_launches,
        "max_abs_err": max([phase2e["segment_aggregate_max_abs_err"]] + errs),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": k1["library_ms"],
        "library_call": "torch.index_add_ of the sum component alone",
        "ms_back_to_back": k1["ms_back_to_back"],
        "ms_is": "stddev(rate(http_requests_total[5m])), phase 11, irregular store, all 8 "
                 "leaves' launches", "by_zone": kernels["segment_aggregate stdvar by (zone)"]},
        {"name": "segment_topk", "route": "cuda",
         "source": "filodb_tpu_torch/csrc/order_stats.cu",
         "replaces": "filodb_tpu/ops/aggregations.py:1904", "launches": topk_launches,
         "max_abs_err": phase2e["segment_topk_max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "library_call": "none for a grouped top-k; torch.topk(grid, 3, dim=1) at G = 1 over "
                         f"the same grids {k2['torch_topk_g1_ms']:.4f} ms",
         "ms_back_to_back": k2["ms_back_to_back"], "device_ms": k2["device_ms"],
         "routes_alternating": k2["routes_alternating"], "route_of_leaves": k2["route"],
         "ms_is": "topk by (zone) (3, rate(http_requests_total[5m])), phase 11, irregular "
                  "store, the 8 leaf filters' launches",
         "cases_phase2e": phase2e["segment_topk_cases"]}]


def tree_kernel_rows(tree: dict, kernels: dict, classic: dict, rung_rows: dict,
                     subqueries: dict) -> list:
    """The kernels line's rows of the tree's kernels (sorted_window, the
    general kernel's predict_linear and Holt-Winters, the standalone
    quantile), timed at phase 10's irregular store (phase 10b for the
    quantile); phase 10's launches of the older rungs go to their rows, and
    phase 13's launches to their kernels' rows."""
    irr = tree["irregular"]
    for per_store in tree.values():
        for q, row in per_store.items():
            func_rung = row["rung"]
            if func_rung in rung_rows and not (func_rung == "general" and q.startswith(
                    ("predict_linear", "holt_winters"))):
                rung_rows[func_rung]["launches"] += row["launches"]

    def row_of(name, source, replaces, queries, err, library=None):
        runs = [tree[g][q] for g in tree for q in queries
                if q in tree[g] and tree[g][q]["rung"] == irr[queries[0]]["rung"]]
        first = irr[queries[0]]
        return {"name": name, "route": "cuda", "source": f"filodb_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(r["launches"] for r in runs),
                "max_abs_err": max([err] + [r["max_abs_err"] for r in runs]),
                "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": None, "library_call": library or "none",
                "ms_back_to_back": first["kernel_ms_back_to_back"],
                "ms_is": f"{queries[0]}, phase 10, irregular store, all 8 leaves' launches",
                "queries": {g: {q: tree[g][q] for q in queries if q in tree[g]} for g in tree}}

    sorted_q = [q for q, r, _ in TREE_QUERIES if r == "sorted"]
    rows = [
        row_of("sorted_window", "sorted_window.cu", "filodb_tpu/ops/kernels.py:333", sorted_q,
               0.0, "none: no torch call takes a quantile of every sliding window"),
        row_of("general_range predict_linear", "general_range.cu",
               "filodb_tpu/ops/kernels.py:232",
               ["predict_linear(http_requests_total[5m], 600)"], kernels["arg_max_abs_err"]),
        row_of("general_range holt_winters", "general_range.cu", "filodb_tpu/ops/kernels.py:289",
               ["holt_winters(http_requests_total[5m], 0.3, 0.1)"], kernels["arg_max_abs_err"]),
    ]
    rows[0]["sorted_max_ulp_phase2d"] = kernels["sorted_max_ulp"]
    rung_rows["mxu"]["launches"] += sum(r["aggregate_launches"] for r in classic.values())
    by_kernel = {"window_range": rung_rows["window_stats"], "regular_range": rung_rows["mxu"],
                 "general_range": rung_rows["general"], "sorted_window": rows[0],
                 "jitter_range": rung_rows["jitter"], "masked_range": rung_rows["masked"]}
    for per_store in subqueries.values():  # phase 13: inner leaves, fused inners, outer launches
        for row in per_store.values():
            for name, n in row.get("launches", {}).items() if isinstance(row, dict) else ():
                by_kernel[name]["launches"] += n
    first = classic[CLASSIC_QUERIES[0][1]]
    rows.append({
        "name": "hist_quantile_gather", "route": "cuda",
        "source": "filodb_tpu_torch/csrc/hist_range.cu",
        "replaces": "filodb_tpu/ops/hist_kernels.py:86",
        "launches": sum(r["gather_launches"] for r in classic.values()),
        "max_abs_err": max([kernels["gather_max_abs_err"]]
                           + [r["max_abs_err"] for r in classic.values()]),
        "max_abs_err_phase2d": kernels["gather_max_abs_err"],
        "ms": first["kernel_ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none: no torch call interpolates histogram_quantile",
        "ms_back_to_back": first["kernel_ms_back_to_back"],
        "device_ms": first["kernel_device_ms"], "host_enqueue_ms": first["host_enqueue_ms"],
        "empty_launch_device_ms": first["empty_launch_device_ms"],
        "ms_is": f"{CLASSIC_QUERIES[0][1]}, phase 10b; device_ms and empty_launch_device_ms "
                 f"by CUDA graph replay", "queries": classic})
    return rows


# -- phase 13: subqueries, the raw export and the metadata plans ------------------------

# (query, instant, repeatable): phase 13's subqueries on phase 4's and phase
# 5's stores. deriv's inner sum by zone is the fused aggregate, whose float
# atomics add its 12,500 rates a zone in another order each run; the slope
# of those sums moves by more than rtol 1e-3 between runs, so its warm run
# is held to the first by labels and NaN masks only (each run's outer
# launch is held to its plain version over its own re-staged block)
SUBQUERY_QUERIES = (
    ("max_over_time(rate(http_requests_total[5m])[10m:1m])", False, True),
    ("quantile_over_time(0.9, rate(http_requests_total[5m])[10m:1m])", False, True),
    ("deriv(sum by (zone) (rate(http_requests_total[5m]))[30m:1m])", False, False),
    ("rate(http_requests_total[5m])[10m:1m]", True, True),
)
# the raw export's selection: 990 of bench.py's 100k instances (host-1000 .. host-99009)
RAW_EXPORT_QUERY = 'http_requests_total{instance=~"host-[0-9]*00[0-9]"}[5m]'


def subquery_plain(func: str, variant: str, b, params, is_counter: bool, args):
    """A subquery's outer range function through the plain version of the
    rung that served it, over the same re-staged block on the card: [S_pad,
    J] values."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import sorted_window as SW

    J, start_off = params.num_steps, int(params.start_ms - b.base_ms)
    if variant == "sorted":
        q, a1 = SW.func_args(args)
        return SW.sorted_window_plain(func, b.ts, b.vals, b.lens, start_off, params.step_ms,
                                      params.window_ms, J, q, a1)
    return AGG.rung_series_plain(variant, func, b, params, is_counter, False, args)[:, :J]


def run_subquery(engine, q: str, instant: bool):
    """One phase-13 query through the engine's planner and the plan's
    execution (the entry points' own calls, so that the context's host split
    can be read), every launch count set to 0 just before and read just
    after: each range-function dispatch (the inner leaves and each inner
    grid's outer launch) one launch of its rung's kernel, a fused inner
    aggregate one of its rung's, and no other kernel. Returns the rows by
    labels, the end-to-end seconds, the host split, the launch counts and
    the outer dispatches (func, variant, block, params, is_counter, args,
    output)."""
    import importlib
    from collections import Counter

    import torch

    from filodb_tpu_torch.ops import kernels as K
    from filodb_tpu_torch.query.exec.joins import SubqueryWindowExec
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan, query_to_logical_plan

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in KERNEL_COUNTERS.items()}
    seen, outer = [], []
    dispatch = K._dispatch_range_function

    def watched(func, block, params, **kw):
        out = dispatch(func, block, params, **kw)
        seen.append(out[1])
        if not block.part_refs:  # a re-staged inner grid: a leaf's block names its partitions
            outer.append((func, out[1], block, params, kw.get("is_counter", False),
                          kw.get("args", ()), out[0]))
        return out

    t0 = time.perf_counter()
    logical = (query_to_logical_plan(q, END_S) if instant
               else query_range_to_logical_plan(q, START_S, END_S, STEP_S))
    plan = engine.planner.materialize(logical)
    t1 = time.perf_counter()
    ctx = engine.context()
    K._dispatch_range_function = watched
    try:
        for name, (_, attr) in KERNEL_COUNTERS.items():
            setattr(mods[name], attr, 0)
        t2 = time.perf_counter()
        res = plan.execute(ctx)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rows = {tuple(sorted(l.items())): v for g in res.grids
                for l, v in zip(g.labels, g.values_np())}
        t4 = time.perf_counter()
        counts = {name: getattr(mods[name], attr) for name, (_, attr) in KERNEL_COUNTERS.items()}
    finally:
        K._dispatch_range_function = dispatch
    want = Counter(TREE_KERNELS[v] for v in seen if TREE_KERNELS[v])
    if ctx.obs.get("path") == "fused":
        want[RUNGS[ctx.obs["variant"]]] += 1
    want = {k: want.get(k, 0) for k in KERNEL_COUNTERS}
    require(counts == want, f"{q}: launches {counts}, expected {want} (rungs {seen})")
    require(isinstance(plan, SubqueryWindowExec) != instant,
            f"{q}: planned as {type(plan).__name__}")
    splits = ctx.obs.get("subquery", [])
    split = {"plan_ms": (t1 - t0) * 1e3, "execute_ms": (t3 - t2) * 1e3,
             "rows_ms": (t4 - t3) * 1e3}
    for k in ("inner_ms", "fetch_ms", "restage_ms", "upload_ms", "launch_ms"):
        split[k] = sum(sp[k] for sp in splits)
    return rows, t4 - t0, split, counts, outer, plan


def check_subquery_outer(outer, what: str) -> float:
    """Each outer launch's rows against the plain version of its rung over
    the same re-staged block (rtol 1e-3, NaN masks equal)."""
    err = 0.0
    for func, variant, block, params, is_counter, args, got in outer:
        if variant == "host":
            continue
        want = subquery_plain(func, variant, block, params, is_counter, args)
        n, J = block.n_series, params.num_steps
        err = max(err, compare(got[:n, :J], want[:n, :J], f"{what} ({variant})", rtol=1e-3))
    return err


def restage_check(engine, plan) -> dict:
    """The subquery's inner grids as one [rows, J'] array on the host
    re-staged by ``stage_step_rows`` against ``stage_series`` over the same
    (times, values) pairs of each row: bit-equal, counter-corrected as the
    outer rate re-stages them and raw."""
    from filodb_tpu_torch.ops import staging as ST

    inner = plan.child_plans[0].execute(engine.context())
    v = np.concatenate([g.values_np() for g in inner.grids])
    times = inner.grids[0].step_times_ms()
    base = plan.start_ms - plan.window_ms - plan.offset_ms
    series = [(times[~np.isnan(r)], r[~np.isnan(r)].astype(np.float64)) for r in v]
    out = {"rows": int(v.shape[0])}
    for corrected in (True, False):
        t0 = time.perf_counter()
        got = ST.stage_step_rows(v, times, base, counter_corrected=corrected)
        t1 = time.perf_counter()
        want = ST.stage_series(series, base, counter_corrected=corrected, sidecar=False)
        t2 = time.perf_counter()
        for name in ("ts", "vals", "lens", "baseline", "raw", "base64"):
            a, b = getattr(got, name), getattr(want, name)
            require((a is None) == (b is None) and (b is None or (
                a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8)))),
                f"phase13 re-staging ({'corrected' if corrected else 'raw'}): {name} differs "
                f"from stage_series")
        require(got.regular_ts is None if want.regular_ts is None
                else np.array_equal(got.regular_ts, want.regular_ts),
                "phase13 re-staging: the grid class differs from stage_series")
        key = "corrected" if corrected else "raw"
        out[f"{key}_ms"] = (t1 - t0) * 1e3
        out[f"{key}_stage_series_ms"] = (t2 - t1) * 1e3
    return out


def phase_subqueries(engine, card: str, grid: str) -> dict:
    """Phase 13 on a 100k-series store (phase 4's irregular or phase
    5's regular one): each ``SUBQUERY_QUERIES`` query first (on the caches
    phase 11 and the queries before it left: phase 11 has just staged the
    inner selection cold) then warm, through ``run_subquery`` (launches
    checked), warm
    equal to first (rtol 1e-3; labels and NaN masks only where not
    repeatable), each outer launch against its rung's plain
    version over the same re-staged block (``check_subquery_outer``); the
    host split of the warm run (plan, inner execution, fetch, re-stage,
    upload, outer launches, rows to the host); on the irregular store the
    re-staging of the first query's 100k inner rows against
    ``stage_series`` (``restage_check``). Then the metadata plans and a raw
    export of 990 series, each against a direct scan of the shards'
    partitions."""
    from filodb_tpu_torch.core.filters import ColumnFilter

    t_phase = time.perf_counter()
    out = {}
    for i, (q, instant, repeatable) in enumerate(SUBQUERY_QUERIES):
        first_rows, first_s, first_split, first_counts, first_outer, plan = run_subquery(
            engine, q, instant)
        first_err = check_subquery_outer(first_outer, f"phase13 {grid} {q} (first)")
        b5 = sum(1 for o in first_outer if o[1] == "mxu" and o[0] in B5_FUNCS)
        del first_outer
        rows, warm_s, split, counts, outer, plan = run_subquery(engine, q, instant)
        err = check_subquery_outer(outer, f"phase13 {grid} {q}")
        require(sorted(rows) == sorted(first_rows) and rows and all(
            np.array_equal(np.isnan(rows[k]), np.isnan(first_rows[k])) for k in rows),
            f"phase13 {q}: warm rows or NaN masks differ from the first run")
        rel = max(float(np.nanmax(np.abs(rows[k] - first_rows[k]) / np.maximum(
            np.abs(first_rows[k]), 1e-30), initial=0.0)) for k in rows)
        require(rel <= 1e-3 or not repeatable, f"phase13 {q}: warm differs from the first run "
                f"by {rel:.3g} relative")
        nonnan = sum(int(np.isfinite(v).sum()) for v in rows.values())
        require(nonnan > 0, f"phase13 {q}: no finite value")
        row = {"first_ms": first_s * 1e3, "warm_ms": warm_s * 1e3, "rows": len(rows),
               "warm_vs_first_max_rel": rel,
               "finite_values": nonnan,
               "launches": {k: v + first_counts[k] for k, v in counts.items()
                            if v + first_counts[k]},
               "outer_rungs": sorted({o[1] for o in outer}), "outer_launches": len(outer),
               "b5_launches": b5 + sum(1 for o in outer if o[1] == "mxu" and o[0] in B5_FUNCS),
               "max_abs_err": max(err, first_err), "first_split": first_split, **split}
        if i == 0 and grid == "irregular":
            row["restage"] = restage_check(engine, plan)
        out[q] = row
        print(f"phase13 {grid} {q!r}{' (instant)' if instant else ''}: {len(rows)} rows; first "
              f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms (plan {split['plan_ms']:.1f}, "
              f"execute {split['execute_ms']:.1f}: inner {split['inner_ms']:.1f}, fetch "
              f"{split['fetch_ms']:.1f}, re-stage {split['restage_ms']:.1f}, upload "
              f"{split['upload_ms']:.1f}, outer launches {split['launch_ms']:.1f}; rows to the "
              f"host {split['rows_ms']:.1f}); launches of both runs {row['launches']} (outer "
              f"{row['outer_rungs']} x {len(outer)}); outer matches plain (max_abs_err "
              f"{row['max_abs_err']:.3g}); warm vs first {rel:.3g} relative{'; re-staged ' + str(row['restage']) if 'restage' in row else ''}; "
              f"on {card}")
        del outer
    ms, ds = engine.memstore, engine.dataset
    parts = [p for sh in ms.shards(ds) for p in sh.partitions.values()]
    meta = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        got = fn()
        meta[name] = {"host_ms": (time.perf_counter() - t0) * 1e3}
        return got

    got = timed("label_values zone", lambda: engine.label_values([], "zone", 0, 2**62))
    require(got == sorted({p.tags["zone"] for p in parts}), "phase13 label_values differ")
    got = timed("label_names", lambda: engine.label_names([], 0, 2**62))
    require(got == sorted({k for p in parts for k in p.tags}), "phase13 label_names differ")
    regex = ColumnFilter("instance", "=~", "host-1[0-9]*7")
    got = timed("series instance=~host-1[0-9]*7", lambda: engine.series([regex], 0, 2**62))
    want = sorted(tuple(sorted(p.tags.items())) for p in parts if regex.matches(p.tags["instance"]))
    require(sorted(tuple(sorted(t.items())) for t in got) == want and want,
            "phase13 series differ")
    meta["series instance=~host-1[0-9]*7"]["series"] = len(got)
    got = timed("ts_cardinalities depth 3", lambda: engine.ts_cardinalities([], 3))
    require([(tuple(r["prefix"]), r["ts_count"]) for r in got] == [
        (("demo", "App-2", "http_requests_total"), len(parts))], "phase13 ts_cardinalities differ")
    t0 = time.perf_counter()
    res = engine.query_range(RAW_EXPORT_QUERY, START_S, END_S, STEP_S)
    meta["raw export"] = {"host_ms": (time.perf_counter() - t0) * 1e3, "series": len(res.raw)}
    lo = int(START_S * 1000) - 300_000
    sel = ColumnFilter("instance", "=~", "host-[0-9]*00[0-9]")
    want = {p.tags["instance"]: p.samples_in_range(lo, int(END_S * 1000), "count")
            for p in parts if sel.matches(p.tags["instance"])}
    require(len(res.raw) == len(want) > 0 and all(
        np.array_equal(ts, want[l["instance"]][0]) and np.array_equal(v, want[l["instance"]][1])
        for l, ts, v in res.raw), "phase13 raw export differs from the partitions' samples")
    print(f"phase13 {grid} metadata: " + "; ".join(
        f"{k} {v['host_ms']:.1f} ms" + (f" ({v['series']} series)" if "series" in v else "")
        for k, v in meta.items()) + f", each equal to a direct scan of the {len(parts)} "
        f"partitions; on {card}")
    out["metadata"] = meta
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase13 {grid}: {out['phase_s']:.1f} s")
    return out


# -- phases 2f and 12: the reference tree over native histograms -----------------------

# K2's cases: (op, q or (lower, upper))
HIST_INSTANT_CASES = ([("quantile", q) for q in (-0.1, 0.0, 0.5, 0.99, 1.0, 1.1)]
                      + [("quantile_even", q) for q in (0.25, 0.9)]
                      + [("fraction", b) for b in ((0.0, 0.25), (-np.inf, np.inf), (-np.inf, 0.1),
                                                   (0.001, 0.002), (0.25, 0.5), (1.0, np.inf))])


def hist_instant_plain(op: str, arg, h, les):
    """K2's plain version for one case."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    if op == "fraction":
        return HK.histogram_fraction_plain(arg[0], arg[1], h, les)
    return HK.histogram_quantile_plain(arg, h, les, even=op == "quantile_even")


def hist_instant_call(op: str, arg, hists: list, les: list) -> list:
    """K2's wrapper for one case over a node's grids (one launch on card
    tensors)."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    kw = {"lower": arg[0], "upper": arg[1]} if op == "fraction" else {"q": arg}
    return HK.hist_instant(op, hists, les, **kw)


def instant_grid_on_card(S: int, J: int, first_le: float, seed: int, device):
    """[S, J, 12] cumulative bucket values drawn on the card (rate-like, to
    three decimals, so that ties across buckets occur) with the edge rows: an
    all-NaN row, a zero total, a NaN inside, counts only in the +Inf bucket;
    bounds ``HIST_LES`` with ``first_le`` first."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    incr = torch.round(torch.rand((S, J, N_BUCKETS), generator=g, device=device) * 2e3) / 1e3
    incr = torch.where(torch.rand((S, J, N_BUCKETS), generator=g, device=device) < 0.3, 0.0, incr)
    h = torch.cumsum(incr, dim=-1)
    h[0] = float("nan")
    h[1] = 0.0
    h[2, :, 3] = float("nan")
    h[3, :, :-1] = 0.0
    les = HIST_LES.astype(np.float32).copy()
    les[0] = first_le
    return h, torch.from_numpy(les).to(device)


def phase_hist_tree_vs_plain(seed: int, device) -> dict:
    """2f: the two kernels of the tree over native histograms against their
    plain versions on seeded card blocks. K1 (the range kernel's store
    mode, ``hist_range_series``): every function of FUSED_HIST_FUNCS x
    is_delta on 7a's blocks (300 and 3000 real rows of 12 buckets, padded
    rows, NaN bucket counts), shared bounds on the regular ones and bounds
    searched per series on the irregular ones: bit-equal to
    ``hist_series_plain`` (padded rows NaN). K2 (``hist_instant``): each op
    of ``HIST_INSTANT_CASES`` on 4096 x 111 x 12 bucket values drawn on the
    card with the edge rows, first bounds 0.005, 0 and -1, in one launch
    with the same grid read through the store's permuted view and a
    6-bucket grid of other bounds: each within 2 ulp of its plain version,
    NaN and infinity masks equal."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

    rng = np.random.default_rng(seed + 13)
    params = RangeParams(BASE - 120_000, 60_000, 80, WINDOW_MS)
    j_pad = pad_steps(params.num_steps)
    k1_cases, k1_err = 0, 0.0
    for grid, n_real in (("regular", 300), ("irregular", 300), ("regular", 3000),
                         ("irregular", 3000)):
        block = hist_block_on_card(grid, n_real, 400, rng, device)
        windows = AGG._hist_shared_windows(block, params, j_pad) if grid == "regular" else None
        gids = AGG.zero_gids(block)
        for func in sorted(HK.FUSED_HIST_FUNCS):
            for is_delta in (False, True):
                got = HK.hist_range_series(func, block, gids, params, windows, is_delta)
                want = HK.hist_series_plain(func, block, gids, params, windows, is_delta)
                what = f"2f {grid} {func} delta={is_delta} ({n_real} rows)"
                err = compare(got, want, what, rtol=0.0)
                require(err == 0.0, f"{what}: not bit-equal (max_abs_err {err})")
                k1_err = max(k1_err, err)
                require(bool(torch.isnan(got[:, :, block.n_series:]).all()),
                        f"{what}: padded rows not NaN")
                k1_cases += 1
        plan = HK.LAST_SERIES_PLAN
        print(f"phase2f {grid} block {list(block.vals.shape)} ({block.n_series} real rows): "
              f"hist_range_series bit-equal to plain for {2 * len(HK.FUSED_HIST_FUNCS)} cases "
              f"({plan.rows} rows per tile, {plan.slices} slice(s) of {plan.steps} steps, "
              f"float{plan.vec}, {plan.threads} threads, ts "
              f"{'staged' if plan.staged else 'in place'})")
    worst_ulp = k2_cases = 0
    k2_err = 0.0
    for first_le in (0.005, 0.0, -1.0):
        h, les = instant_grid_on_card(4096, 111, first_le, seed + 14, device)
        store = h.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        few, few_les = h[:1000, :, 6:].contiguous(), les[6:].contiguous()
        grids = (("row-major", h, les), ("store", store, les), ("6 buckets", few, few_les))
        for op, arg in HIST_INSTANT_CASES:
            before = HK.INSTANT_LAUNCHES
            outs = hist_instant_call(op, arg, [g for _, g, _ in grids], [b for *_, b in grids])
            require(HK.INSTANT_LAUNCHES == before + 1, f"2f {op}: one launch for three grids")
            for (layout, grid_t, b), got in zip(grids, outs):
                want = hist_instant_plain(op, arg, grid_t, b)
                gap = ulp_gap(got, want)
                require(gap <= 2, f"2f {op} {arg} les[0]={first_le} {layout}: {gap} ulp")
                worst_ulp, k2_err = max(worst_ulp, gap), max(k2_err, abs_gap(got, want))
                k2_cases += 1
    del h, store, few
    print(f"phase2f hist_instant within {worst_ulp} ulp (max_abs_err {k2_err}) of plain "
          f"(<= 2 ulp required) over "
          f"{k2_cases} cases: {len(HIST_INSTANT_CASES)} ops x first bounds 0.005, 0, -1 x "
          f"row-major, store and 6-bucket grids, the three in one launch")
    return {"series_cases": k1_cases, "series_max_abs_err": k1_err, "instant_cases": k2_cases,
            "instant_max_ulp": worst_ulp, "instant_max_abs_err": k2_err}


HIST_TREE_QUERIES = (
    "rate(http_request_latency[5m])",
    "histogram_quantile(0.99, rate(http_request_latency[5m]))",
    "histogram_fraction(0, 0.25, rate(http_request_latency[5m]))",
    "histogram_bucket(0.5, rate(http_request_latency[5m]))",
)
# run once on the caches the first two left (the script's time): the
# answer warm, not first then warm
HIST_TREE_ONCE = frozenset(HIST_TREE_QUERIES[2:])
# with fused_aggregate=False, held against the fused answer
HIST_UNFUSED_QUERY = "histogram_quantile(0.9, sum by (zone) (rate(http_request_latency[5m])))"
HIST_TREE_COUNTERS = dict(KERNEL_COUNTERS, segment_agg=("segment_agg", "LAUNCHES"),
                          hist_series=("hist_kernels", "SERIES_LAUNCHES"),
                          hist_instant=("hist_kernels", "INSTANT_LAUNCHES"))


def expected_hist_launches(plan) -> dict:
    """The launches a histogram tree plan makes: K1 per shard leaf; K2 per
    histogram-function node (all the grids it sees in one launch); a
    segment aggregate per leaf's map phase."""
    from filodb_tpu_torch.query.exec import plans as P
    from filodb_tpu_torch.query.exec import transformers as TR

    leaves = []

    def walk(node):
        if isinstance(node, P.SelectRawPartitionsExec):
            leaves.append(node)
        for c in node.children():
            walk(c)

    walk(plan)
    funcs = sum(isinstance(t, TR.InstantVectorFunctionMapper) and t.function in
                TR._HIST_INSTANT_OPS for t in plan.transformers)
    maps = sum(isinstance(t, P.AggregateMapReduce) for leaf in leaves for t in leaf.transformers)
    return {"hist_series": len(leaves), "hist_instant": funcs, "segment_agg": maps}


def hist_tree_result(res, device):
    """A histogram tree query's answer on ``device``: the buckets [N, J, B]
    of a histogram result, else the values [N, J] (the grids' rows
    stacked)."""
    import torch

    from filodb_tpu_torch.query.exec.transformers import grid_hist, grid_values

    if res.grids and res.grids[0].hist is not None:
        return torch.cat([grid_hist(g, device) for g in res.grids])
    return torch.cat([grid_values(g).to(device) for g in res.grids])


def run_hist_tree(engine, q: str):
    """One phase-12 query through the user's entry point, every launch count
    set to 0 just before and read just after: the launches of
    ``expected_hist_launches`` and no other kernel. Returns the result, its
    answer on the card, the end-to-end seconds (rows to the host included)
    and the counts with the warm split (``plan_ms`` planning alone,
    ``execute_ms`` the engine's call to the card's last kernel,
    ``rows_ms`` the rows -- [S, J, B] buckets of a histogram answer -- to
    the host)."""
    import importlib

    import torch

    mods = {name: importlib.import_module(f"filodb_tpu_torch.ops.{mod}")
            for name, (mod, _) in HIST_TREE_COUNTERS.items()}
    t0 = time.perf_counter()
    want = expected_hist_launches(exec_node(engine, q))
    plan_ms = (time.perf_counter() - t0) * 1e3
    for name, (_, attr) in HIST_TREE_COUNTERS.items():
        setattr(mods[name], attr, 0)
    t0 = time.perf_counter()
    res = engine.query_range(q, START_S, END_S, STEP_S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for g in res.grids:
        g.values_np()
        g.hist_np()
    wall = time.perf_counter() - t0
    counts = {name: getattr(mods[name], attr) for name, (_, attr) in HIST_TREE_COUNTERS.items()}
    got = {k: counts[k] for k in want}
    require(got == want, f"{q}: launches {counts}, expected {want}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"{q}: other kernels launched: {others}")
    return res, hist_tree_result(res, engine.device), wall, {**want, "plan_ms": plan_ms,
                                              "execute_ms": (t1 - t0) * 1e3,
                                              "rows_ms": (wall - (t1 - t0)) * 1e3}


class plain_hist_tree:
    """Within it, the engine runs K1, K2 and the segment aggregate through
    their plain versions (on the card's tensors)."""

    def __enter__(self):
        from filodb_tpu_torch.ops import aggregations as AGG
        from filodb_tpu_torch.ops import hist_kernels as HK
        from filodb_tpu_torch.ops import segment_agg as SA

        def series(func, block, gids, params, windows=None, is_delta=False):
            return HK.hist_series_plain(func, block, gids, params, windows, is_delta)

        def instant(op, hists, les, q=0.0, lower=0.0, upper=0.0):
            arg = (lower, upper) if op == "fraction" else q
            return [hist_instant_plain(op, arg, h, b) for h, b in zip(hists, les)]

        def components(values, gids, G, comps, lib=None):
            return {c: AGG.segment_aggregate(c, values, gids.long(), G) for c in comps}

        self.saved = [(m, a, getattr(m, a)) for m, a in (
            (HK, "hist_range_series"), (HK, "hist_instant"), (SA, "segment_components"))]
        for (m, a, _), f in zip(self.saved, (series, instant, components)):
            setattr(m, a, f)
        return self

    def __exit__(self, *exc):
        for m, a, f in self.saved:
            setattr(m, a, f)
        return False


def hist_tree_leaves(engine, q: str):
    """The query's leaves' staged selections on the card (warm: served from
    the shards' staging caches) with their mappers: (mapper, RawGrid)."""
    from filodb_tpu_torch.query.exec.plans import SelectRawPartitionsExec

    plan = exec_node(engine, q)
    out = []

    def walk(node):
        if isinstance(node, SelectRawPartitionsExec):
            ctx = engine.context()
            for rg in node.do_execute(ctx).raw_grids:
                out.append((node.transformers[0], rg))
            require(ctx.stats.cache_misses == 0, f"{q}: a leaf's warm read staged")
        for c in node.children():
            walk(c)

    walk(plan)
    return out


def time_hist_tree_kernels(pairs, card: str, phase: str, split_libs=None) -> dict:
    """K1 over the query's leaves (every leaf's store launch into a buffer
    of its own), and K2's histogram_quantile(0.99) over those leaves' grids
    (one launch for all of them): each median of 20 calls and back to
    back, K1 also on the device alone (``torch.profiler``) and in the store
    mode's split builds (``store: compute only``: no store; ``store: store
    only``: fixed values, no fetch, no search), beside the bound (bytes at 3.35 TB/s: K1
    the buckets at the windows' distinct first and last samples, each
    row's timestamps on per-series bounds, gids and the [S, J, B] grid
    written once; K2 the grid read once and [S, J] written once) and the
    plain versions' ms."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import pad_steps

    launches, grids, k1_bytes, k2_bytes = [], [], 0, 0
    for mapper, rg in pairs:
        b, params = rg.block, mapper.range_params()
        J, (S, T, B) = params.num_steps, b.vals.shape
        windows = (AGG._hist_shared_windows(b, params, pad_steps(J))
                   if AGG.hist_variant(b) == "hist_shared" else None)
        gids = AGG.zero_gids(b)
        out = torch.empty((J, B, S), dtype=torch.float32, device=b.vals.device)

        def launch(b=b, gids=gids, params=params, windows=windows, out=out, lib=None):
            HK._launch_series("rate", b, gids, params, windows, False, out, lib=lib)

        launches.append(launch)
        launches[-1]()
        grids.append((b, gids, params, windows, out.permute(2, 0, 1)[: b.n_series]))
        bound, _, _ = hist_bound_bytes(b, params, 0, windows)
        k1_bytes += bound + b.n_series * J * B * 4
        k2_bytes += b.n_series * J * (B + 1) * 4
    les = torch.from_numpy(HIST_LES.astype(np.float32)).to(pairs[0][1].block.vals.device)

    def k1(lib=None):
        for launch in launches:
            launch(lib=lib)

    def k2():  # one launch for the 8 leaf grids, as the plan node makes it
        HK.hist_instant("quantile", [h for *_, h in grids], [les] * len(grids), q=0.99)

    gpu_sample(f"{phase} before")
    k1_ms, k1_b2b = cuda_ms(k1, reps=20), back_to_back_ms(k1, reps=20)
    k1_dev = device_ms(k1, "hist_range", reps=10)
    split = {name: back_to_back_ms(lambda lib=lib: k1(lib), reps=20)
             for name, lib in (split_libs or {}).items() if name.startswith("store:")}
    plan = HK.LAST_SERIES_PLAN
    k2_ms, k2_b2b = cuda_ms(k2, reps=20), back_to_back_ms(k2, reps=20)
    gpu_sample(f"{phase} after")
    k1_plain = cuda_ms(lambda: [HK.hist_series_plain("rate", b, g, p, w)
                                for b, g, p, w, _ in grids], reps=1, warmup=1)
    k2_plain = cuda_ms(lambda: [HK.histogram_quantile_plain(0.99, h, les) for *_, h in grids],
                       reps=3, warmup=1)
    to_ms = 1e3 / HBM_BYTES_PER_S
    row = {"k1_ms": k1_ms, "k1_ms_back_to_back": k1_b2b, "k1_device_ms": k1_dev,
           "k1_split_ms_back_to_back": split, "k1_plain_ms": k1_plain,
           "k1_bound_ms": k1_bytes * to_ms, "k1_bound_bytes": k1_bytes,
           "k1_plan": {"rows": plan.rows, "slices": plan.slices, "steps": plan.steps,
                       "vec": plan.vec, "threads": plan.threads, "staged": plan.staged},
           "k2_ms": k2_ms, "k2_ms_back_to_back": k2_b2b, "k2_plain_ms": k2_plain,
           "k2_bound_ms": k2_bytes * to_ms, "k2_bound_bytes": k2_bytes, "leaves": len(pairs)}
    split_note = "".join(f"; {k} {v:.4f} ms" for k, v in split.items())
    print(f"{phase}: K1 hist_range_series x {len(pairs)} leaves {k1_ms:.4f} ms (median of 20; "
          f"{k1_b2b:.4f} ms back to back; device {k1_dev:.4f} ms; {plan.rows} rows per tile, "
          f"{plan.threads} threads, ts {'staged' if plan.staged else 'in place'}{split_note}), "
          f"bound {row['k1_bound_ms']:.4f} ms "
          f"({k1_bytes} bytes), plain {k1_plain:.2f} ms; K2 hist_instant quantile, one "
          f"launch over {len(pairs)} grids, {k2_ms:.4f} ms ({k2_b2b:.4f} ms back to back), bound "
          f"{row['k2_bound_ms']:.4f} ms ({k2_bytes} bytes), plain {k2_plain:.3f} ms; on {card}")
    return row


def phase_hist_tree(engine, card: str, grid: str, queries, split_libs=None) -> dict:
    """Phase 12: the reference tree over native histograms on a histogram
    store (7b's regular one, after its live edge, or 7c's irregular one):
    ``queries`` through ``QueryEngine``, each first (the phase's first with
    fresh caches, every shard staged; the others read the staging caches
    it filled) then warm (``HIST_TREE_ONCE``: one run, already warm), with
    their launches checked (``run_hist_tree``),
    the warm answer equal to the first and to the plain path on the card
    (K1's buckets and K2's bucket slice bit-equal, K2's values within 2
    ulp); then ``HIST_UNFUSED_QUERY`` with fused_aggregate=False, against
    the plain path and the fused answer (rtol 1e-3), the fused one's launch
    checked by ``run_hist``; then K1 and K2 timed at the leaves' shapes."""
    import torch

    from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine

    out, launches = {}, {"hist_series": 0, "hist_instant": 0, "segment_agg": 0}
    unfused = QueryEngine(engine.memstore, engine.dataset,
                          params=PlannerParams(fused_aggregate=False))
    for i, (q, eng) in enumerate([(q, engine) for q in queries] + [(HIST_UNFUSED_QUERY,
                                                                     unfused)]):
        if i == 0:
            cold_cache(engine)
        once = q in HIST_TREE_ONCE
        res, first, first_s, c1 = run_hist_tree(eng, q)
        if not once:
            res, warm, warm_s, c2 = run_hist_tree(eng, q)
        else:
            warm, warm_s, c2 = first, first_s, c1
        for k in launches:
            launches[k] += c1[k] + (0 if once else c2[k])
        require(torch.equal(torch.isnan(warm), torch.isnan(first)) and torch.allclose(
            warm, first, rtol=1e-3, equal_nan=True), f"{q}: warm differs from first")
        st = res.stats
        require(st.cache_misses == 0 and st.bytes_staged == 0,
                f"{q}: the warm run must stage nothing, stats {st}")
        with plain_hist_tree():
            want = hist_tree_result(eng.query_range(q, START_S, END_S, STEP_S), eng.device)
        abs_err = None
        if "quantile" in q or "fraction" in q:
            err = float(ulp_gap(warm, want)) if eng is engine else compare(
                warm, want, f"phase12 {grid} {q}", rtol=1e-3)
            if eng is engine:
                require(err <= 2, f"phase12 {grid} {q}: {err} ulp from the plain path")
                abs_err = abs_gap(warm, want)
        else:
            err = compare(warm, want, f"phase12 {grid} {q}", rtol=0.0)
            require(err == 0.0, f"phase12 {grid} {q}: not bit-equal to the plain path")
        require(bool(torch.isfinite(warm).any()), f"{q}: no finite value")
        row = {"first_ms": first_s * 1e3, "warm_ms": warm_s * 1e3, "rows": int(warm.shape[0]),
               "shape": list(warm.shape), "vs_plain": err, "vs_plain_abs_err": abs_err,
               **{k: c2[k] for k in ("plan_ms", "execute_ms", "rows_ms")},
               "launches": {k: c2[k] for k in launches}}
        if eng is unfused:
            fused_res, _, _, counts = run_hist(engine, q, grid, "hist_shared" if
                                               grid == "regular" else "hist_general")

            def by_labels(r):
                return {tuple(sorted(l.items())): v for g in r.grids
                        for l, v in zip(g.labels, g.values_np())}

            row["vs_fused_max_abs_err"] = rows_match(by_labels(res), by_labels(fused_res),
                                                     f"phase12 {grid} unfused vs fused")
            row["groups"] = len(fused_res.grids[0].labels)
            row["fused_launches"] = counts
            q = f"{q} [fused_aggregate=False]"
        print(f"phase12 {grid} {q!r}: answer {row['shape']}; first {row['first_ms']:.1f} ms, "
              f"warm {row['warm_ms']:.1f} ms (warm split: plan {row['plan_ms']:.2f}, execute "
              f"{row['execute_ms']:.2f}, rows to the host {row['rows_ms']:.2f} ms); launches "
              f"{row['launches']}; vs plain {err:.3g}"
              f"{'' if 'vs_fused_max_abs_err' not in row else '; vs fused %.3g' % row['vs_fused_max_abs_err']}"
              f"; on {card}")
        out[q] = row
    timing = time_hist_tree_kernels(hist_tree_leaves(engine, queries[0]), card,
                                    f"phase12 {grid}", split_libs)
    return {"queries": out, "launches": launches, **timing}


def hist_tree_rows(hist_tree: dict, phase2f: dict) -> list:
    """The kernels line's rows of K1 and K2, timed at phase 12's regular
    store (7b's: 100k histograms, 8 leaves)."""
    reg = hist_tree["regular"]
    launches = {k: sum(t["launches"][k] for t in hist_tree.values())
                for k in ("hist_series", "hist_instant")}
    errs = [r["vs_plain"] for t in hist_tree.values() for q, r in t["queries"].items()
            if "quantile" not in q and "fraction" not in q]
    return [{
        "name": "hist_range_series", "route": "cuda",
        "source": "filodb_tpu_torch/csrc/hist_range.cu",
        "replaces": "filodb_tpu/ops/hist_kernels.py:29",
        "also_replaces": "filodb_tpu/ops/hist_kernels.py:157 (_hist_range_shared)",
        "launches": launches["hist_series"],
        "max_abs_err": max([phase2f["series_max_abs_err"]] + errs),
        "ms": reg["k1_ms"], "plain_ms": reg["k1_plain_ms"], "bound_ms": reg["k1_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none: no torch call computes a windowed, extrapolated per-bucket rate",
        "ms_back_to_back": reg["k1_ms_back_to_back"], "device_ms": reg["k1_device_ms"],
        "split_ms_back_to_back": reg["k1_split_ms_back_to_back"], "plan": reg["k1_plan"],
        "ms_is": "rate(http_request_latency[5m]), phase 12, 7b's regular store, all 8 leaves' "
                 "launches",
        "per_series_bounds": {k: hist_tree["irregular"][k] for k in (
            "k1_ms", "k1_ms_back_to_back", "k1_device_ms", "k1_split_ms_back_to_back",
            "k1_plain_ms", "k1_bound_ms")}
        if "irregular" in hist_tree else None,
    }, {
        "name": "hist_instant", "route": "cuda",
        "source": "filodb_tpu_torch/csrc/hist_range.cu",
        "replaces": "filodb_tpu/ops/hist_kernels.py:124",
        "also_replaces": "filodb_tpu/ops/hist_kernels.py:86 (histogram_quantile, with even)",
        "launches": launches["hist_instant"],
        "max_abs_err": max([phase2f["instant_max_abs_err"]] + [
            r["vs_plain_abs_err"] for t in hist_tree.values() for r in t["queries"].values()
            if r["vs_plain_abs_err"] is not None]),
        "max_ulp": max([phase2f["instant_max_ulp"]] + [
            r["vs_plain"] for t in hist_tree.values() for r in t["queries"].values()
            if r["vs_plain_abs_err"] is not None]),
        "ms": reg["k2_ms"], "plain_ms": reg["k2_plain_ms"], "bound_ms": reg["k2_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none: no torch call interpolates histogram_quantile or "
                        "histogram_fraction",
        "ms_back_to_back": reg["k2_ms_back_to_back"],
        "ms_is": "histogram_quantile(0.99, .) over rate(http_request_latency[5m])'s 8 leaf "
                 "grids in one launch, phase 12, 7b's regular store"}]


# -- phase 2g: the regular kernel's B5 codes and the jitter kernel vs plain --------------

B5_FUNCS = ("changes", "resets", "min_over_time", "max_over_time", "deriv", "predict_linear",
            "absent_over_time")
STAGINGS = {"gauge": {}, "corrected": {"counter_corrected": True},
            "diff": {"diff_encode": True}, "shifted": {"subtract_baseline": True}}
# the functions each staging mode serves (plans._stage_mode_for_function)
B5_BY_STAGING = {"gauge": B5_FUNCS, "diff": ("changes", "resets"),
                 "shifted": ("deriv", "predict_linear")}
JITTER_BY_STAGING = {"gauge": None, "corrected": ("rate", "increase", "irate"),
                     "diff": ("idelta",), "shifted": ("delta", "stddev_over_time", "z_score")}
EXACT_FUNCS = ("count_over_time", "present_over_time", "absent_over_time", "changes", "resets")
# (real series, samples): a near-regular grid needs two series (one is regular)
PHASE2G_SIZES = ((1, 120), (65, 120), (65, 760), (4096, 760))


def near_regular_series(kind: str, n_real: int, n: int, counter: bool, rng):
    """Seeded series on one 10 s grid: exact (``regular``), each sample
    moved by a rounded uniform +-5 % (``jitter``), or that with 1 % of
    each series' interior slots missed (``holes``, bench.py's draw)."""
    nominal = BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000
    out = []
    for _ in range(n_real):
        ts = nominal.copy()
        if kind != "regular":
            ts += np.rint(rng.uniform(-0.05, 0.05, n) * 10_000).astype(np.int64)
        vals = (np.cumsum(rng.uniform(0, 10, n)) + 1e3) if counter else (
            50 + 20 * rng.standard_normal(n))
        if kind == "holes":
            keep = np.ones(n, bool)
            keep[rng.choice(np.arange(1, n - 1), max(2, int(0.01 * n)), replace=False)] = False
            ts, vals = ts[keep], vals[keep]
        out.append((ts, vals))
    return out


def phase2g_case(variant: str, func: str, block, params, counter: bool, args, errs: dict):
    """One function on one block: the store mode and the aggregate at G =
    S (each row its own group) and G = 8 against the plain version; counts
    exact, NaN masks equal, values within rtol 2e-4 / atol 1e-4 (G = 8:
    rtol 1e-3, atomics reorder a group's sums). Returns the launches."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA

    J = params.num_steps
    kw = {"is_counter": counter, "args": args} if variant == "mxu" else {"is_counter": counter}
    sj = AGG.rung_series_plain(variant, func, block, params, counter, False, args)
    gids = AGG.zero_gids(block)
    got = AGG.rung_series(variant)(func, block, gids, 1, params, **kw)
    want = GA.series_grid(sj, gids, 1, J)
    what = f"phase2g {variant} {func} S={block.n_series} T={block.vals.shape[1]}"
    exact = func in EXACT_FUNCS
    err = {"store": compare(got[:J], want[:J], f"{what} store", rtol=0 if exact else 2e-4,
                            atol=0 if exact else 1e-4)}
    S = block.vals.shape[0]
    for G, rtol, key in ((block.n_series, 2e-4, "G=S"), (8, 1e-3, "G=8")):
        g = torch.full((S,), G, dtype=torch.int64, device=block.vals.device)
        g[: block.n_series] = torch.arange(block.n_series, device=g.device) % G
        agg = AGG.rung_aggregate(variant)(func, "sum", block, g, G, params, **kw)[:, :J]
        ref = AGG.apply_epilogue(sj, ("agg", "sum"), g, G)[:, :J]
        exact_g = exact and G == block.n_series
        err[key] = compare(agg, ref, f"{what} G={G}", rtol=0 if exact_g else rtol,
                           atol=0 if exact_g else 1e-4)
    seen = errs.setdefault((variant, func), {})
    for k, e in err.items():
        seen[k] = max(seen.get(k, 0.0), e)
    return 3


def phase_jitter_vs_plain(seed: int, device) -> dict:
    """Phase 2g: the regular kernel's B5 codes (``B5_BY_STAGING``) on
    regular blocks, and the jitter kernel's two variants (every function
    of ``JITTER_FUNCS`` by staging mode) on jittered and holey blocks,
    kernel against plain (``phase2g_case``) at ``PHASE2G_SIZES``, padded
    to T 128 and 768; then the rungs' decline: a window of twice the
    grid's deviation bound takes the window-stats rung, one of twice it
    plus 1 ms the jitter rung, whose narrow windows are held to plain
    too. Prints max_abs_err per code."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import mxu_jitter as JR
    from filodb_tpu_torch.ops.kernels import RangeParams
    from filodb_tpu_torch.ops.staging import grid_class, stage_series

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 16)
    errs, launches, blocks = {}, 0, 0
    params = RangeParams(BASE + 400_000, 60_000, 40, 300_000)
    for n_real, n in PHASE2G_SIZES:
        for kind in ("regular", "jitter", "holes"):
            if kind != "regular" and n_real == 1:
                n_real_k = 2
            else:
                n_real_k = n_real
            for staging, mode in STAGINGS.items():
                funcs = (B5_BY_STAGING.get(staging) if kind == "regular"
                         else JITTER_BY_STAGING[staging] or sorted(JR.JITTER_FUNCS))
                if not funcs:
                    continue
                counter = staging != "gauge"
                series = near_regular_series(kind, n_real_k, n, counter, rng)
                block = stage_series(series, BASE, sidecar=False, **mode).to_device(device)
                require(grid_class(block) == kind, f"phase2g: a {kind} block classed "
                                                   f"{grid_class(block)}")
                variant = {"regular": "mxu", "jitter": "jitter", "holes": "masked"}[kind]
                blocks += 1
                for func in funcs:
                    args = (600.0,) if func == "predict_linear" else ()
                    launches += phase2g_case(variant, func, block, params, counter, args, errs)
    # the decline, on a jittered and a holey block
    for kind in ("jitter", "holes"):
        block = stage_series(near_regular_series(kind, 65, 760, False, rng), BASE).to_device(
            device)
        md = block.maxdev_ms if kind == "jitter" else block.mgrid.maxdev_ms
        decl = AGG.grid_variant(block, "rate", False, 2 * md)
        take = AGG.grid_variant(block, "rate", False, 2 * md + 1)
        require(decl == "window_stats" and take == ("jitter" if kind == "jitter" else "masked"),
                f"phase2g {kind}: windows of {2 * md} / {2 * md + 1} ms took {decl} / {take}")
        narrow = RangeParams(BASE + 400_000, 15_000, 40, 2 * md + 1)
        for func in ("count_over_time", "sum_over_time", "rate", "last", "min_over_time"):
            launches += phase2g_case(take, func, block, narrow, False, (), errs)
    per_code = {f"{v} {f}": e for (v, f), e in sorted(errs.items())}
    print(f"phase2g: {blocks} blocks ({PHASE2G_SIZES} real series x samples, regular / "
          f"jittered / holey), {launches} launches: every code equals its plain version "
          f"(counts exact, rtol 2e-4 / atol 1e-4; G = 8 rtol 1e-3); windows of twice the "
          f"deviation bound take window_stats, one ms more the jitter rungs; "
          f"{time.perf_counter() - t0:.1f} s")
    for code, e in per_code.items():
        print(f"phase2g max_abs_err {code}: store {e['store']:.3g}, G = S {e['G=S']:.3g}, "
              f"G = 8 {e['G=8']:.3g} (atomics reorder a group's sums)")

    def worst(variant):  # kernel against plain per series: the store mode and G = S
        return max(max(e["store"], e["G=S"]) for (v, _), e in errs.items() if v == variant)

    return {"max_abs_err": per_code, "launches": launches, "b5_max_abs_err": worst("mxu"),
            "jitter_max_abs_err": worst("jitter"), "masked_max_abs_err": worst("masked")}


def jitter_planes(variant: str, func: str, is_counter: bool, is_delta: bool) -> int:
    """The [S, T] planes a jitter-kernel function reads (csrc/jitter_range.cu)."""
    counts = func in ("count_over_time", "present_over_time", "absent_over_time")
    sums = func in ("sum_over_time", "avg_over_time", "stddev_over_time", "stdvar_over_time",
                    "z_score") or (is_delta and func in ("rate", "increase"))
    cap = is_counter and not is_delta and func in ("rate", "increase")
    if variant == "jitter":  # ts; vals; raw for the counter cap
        return 1 if counts else 2 + int(cap)
    if counts:  # ffd, bfd, cc
        return 3
    if func in ("min_over_time", "max_over_time"):  # vals, ffd, cc
        return 3
    if sums:  # vals, ffd, bfd, cc
        return 4
    if func in ("rate", "increase", "delta"):  # ffd, bfd, cc, bfv, ffv (+ bfraw)
        return 5 + int(cap)
    if func in ("irate", "idelta"):  # vals, ffd, bfd, cc, ffv, ff2v, ff2d
        return 7
    return 5  # first/last: vals, ffd, bfd, cc and one fill


def jitter_bound_bytes(variant: str, func: str, block, n: int, J: int, is_counter: bool,
                       is_delta: bool) -> int:
    """The least bytes a jitter-kernel launch reads: every real slot of each
    plane the function reads, once (5 m windows at 1 m steps cover every
    slot, and 32-byte sectors of 8 slots every window edge), and the real
    rows' gids; the caller adds the output."""
    if variant == "jitter":
        slots = int(block.lens[:n].sum())
    else:
        slots = n * block.mgrid.n_valid
    return jitter_planes(variant, func, is_counter, is_delta) * slots * 4 + n * 8


# -- phase 14: bench.py's fused_jitter stores ---------------------------------------------

# (query, kind: fused aggregate, fused epilogue or tree leaves), grouped by
# staging mode (corrected, raw, shifted): a holey superblock with its
# sidecar takes 4.8 GB, so the cache's 8 GB holds one mode at a time
FUSED_JITTER_QUERIES = (
    ("sum(rate(http_requests_total[5m]))", "fused"),
    ("sum by (zone) (rate(http_requests_total[5m]))", "fused"),
    ("sum(irate(http_requests_total[5m]))", "fused"),
    ("topk(5, rate(http_requests_total[5m]))", "epilogue"),
    ("sum(min_over_time(http_requests_total[5m]))", "fused"),
    ("sum(max_over_time(http_requests_total[5m]))", "fused"),
    ("sum(count_over_time(http_requests_total[5m]))", "fused"),
    ("sum(stddev_over_time(http_requests_total[5m]))", "fused"),
    ("rate(http_requests_total[5m])", "tree"),
    ("changes(http_requests_total[5m])", "tree"),
    ("deriv(http_requests_total[5m])", "tree"),
)
FUSED_JITTER_STORES = (("jitter5pct", 0.0, "jitter", "jitter"),
                       ("jitter_holes", 0.01, "holes", "masked"))
WARM_P50_RUNS = 15


def oracle_sum_rate(ms) -> np.ndarray:
    """bench.py's ``cpu_oracle_ragged``: the f64 sum(rate) over every
    partition's own samples (missed scrapes too), vectorized over the
    series: the samples gathered per partition into [n, T] rows, each
    window's bounds found once for all rows."""
    num_steps = int((END_S - START_S) // STEP_S) + 1
    out_t = np.int64(START_S * 1000) + np.arange(num_steps, dtype=np.int64) * int(STEP_S * 1000)
    rows = [p.samples_in_range(int(out_t[0] - WINDOW_MS), int(out_t[-1]), "count")
            for sh in ms.shards("prometheus") for p in sh.partitions.values()]
    rows = [(ts, v) for ts, v in rows if len(ts)]
    n, T = len(rows), max(len(ts) for ts, _ in rows)
    ts = np.full((n, T), int(out_t[-1]) + 10**9, np.int64)  # past every window, below a row's offset
    v = np.zeros((n, T), np.float64)
    lens = np.array([len(t) for t, _ in rows])
    for i, (t, x) in enumerate(rows):
        ts[i, : len(t)], v[i, : len(t)] = t, x
    drops = np.where(v[:, 1:] < v[:, :-1], v[:, :-1], 0.0)
    cv = v + np.concatenate([np.zeros((n, 1)), np.cumsum(drops, axis=1)], axis=1)
    # per-row searchsorted as one sorted search over rows offset far apart
    off = (np.arange(n, dtype=np.int64) * (1 << 44))[:, None]
    flat = (ts + off).ravel()
    hi = np.searchsorted(flat, (out_t[None, :] + off).ravel(), side="right").reshape(n, -1)
    lo = np.searchsorted(flat, (out_t[None, :] - WINDOW_MS + off).ravel(),
                         side="right").reshape(n, -1)
    base = np.arange(n)[:, None] * T
    hi, lo = np.minimum(hi - base, lens[:, None]), np.minimum(lo - base, lens[:, None])
    cnt = hi - lo
    lo_c, hi_c = np.minimum(lo, lens[:, None] - 1), np.minimum(hi - 1, lens[:, None] - 1)
    take = lambda a, i: np.take_along_axis(a, i, axis=1)  # noqa: E731
    tf, tl = take(ts, lo_c) / 1e3, take(ts, hi_c) / 1e3
    vf, vl, raw_f = take(cv, lo_c), take(cv, hi_c), take(v, lo_c)
    dlt = vl - vf
    sampled = tl - tf
    dur_start = tf - (out_t / 1e3 - WINDOW_MS / 1e3)
    dur_end = out_t / 1e3 - tl
    avg_dur = sampled / np.maximum(cnt - 1, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        dur_zero = np.where(dlt > 0, sampled * (raw_f / np.maximum(dlt, 1e-30)), np.inf)
        ds = np.minimum(dur_start, np.where(raw_f >= 0, dur_zero, np.inf))
        thresh = avg_dur * 1.1
        ds = np.where(ds >= thresh, avg_dur / 2, ds)
        de = np.where(dur_end >= thresh, avg_dur / 2, dur_end)
        factor = (sampled + ds + de) / np.maximum(sampled, 1e-30)
        rate = np.where(cnt >= 2, dlt * factor / (WINDOW_MS / 1e3), np.nan)
    return np.nan_to_num(rate, nan=0.0).sum(axis=0)


def fused_jitter_query(engine, q: str, kind: str, want_class: str, rung: str, card: str,
                       label: str) -> dict:
    """One phase-14 query, first then warm through the user's entry point
    (``run_main``: its rung and one launch; the epilogue's store mode and
    one order-statistics launch, ``run_epilogue_query``; the tree's leaves,
    ``run_tree``), the answer against the plain path on the card, and for
    the fused aggregates against the rung the JAX ladder's general mapping
    would take on the same superblock (window stats or general, exact
    windows), with both kernels timed alternating."""
    import torch

    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA

    if kind == "epilogue":
        row = run_epilogue_query(engine, q, rung, want_class, card)
        row["launches"] = 4
        return row
    if kind == "tree":
        func = q.split("(")[0]
        tree_rung = rung if func == "rate" else "general"
        first, first_rows, first_s = run_tree(engine, q, tree_rung)
        warm, rows, warm_s = run_tree(engine, q, tree_rung)
        pairs = tree_leaves(engine, q)
        want = torch.cat([tree_plain(m, rg)[: rg.block.n_series] for m, rg in pairs])
        err = compare(torch.as_tensor(rows, device=want.device, dtype=want.dtype), want,
                      f"phase14 {label} {q}", rtol=1e-3)
        require(np.array_equal(np.isnan(rows), np.isnan(first_rows)),
                f"phase14 {q}: warm NaN mask differs from the first run's")
        print(f"phase14 {label} {q!r}: {tree_rung} on {len(warm.grids)} leaves, first "
              f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms; rows match plain "
              f"(max_abs_err {err:.3g}) on {card}")
        return {"rung": tree_rung, "first_ms": first_s * 1e3, "warm_ms": warm_s * 1e3,
                "max_abs_err": err, "launches": 2 * len(warm.grids)}
    runs = [run_main(engine, q, want_class, rung) for _ in range(2)]
    require(runs[1][0].stats.cache_hits == 1 and runs[1][0].stats.bytes_staged == 0,
            f"phase14 {q}: the warm run must hit the superblock cache, {runs[1][0].stats}")
    ex = exec_node(engine, q)
    entry = ex.superblock(engine.context())
    gids, G, params = path_args(entry, ex)
    J, func = ex.num_steps(), ex.function
    flags = (entry.is_counter, entry.is_delta)
    sj = AGG.rung_series_plain(rung, func, entry.block, params, *flags)
    # the kernel per series (its store mode) against plain: no sum to reorder
    zero = AGG.zero_gids(entry.block)
    store = AGG.rung_series(rung)(func, entry.block, zero, 1, params, is_counter=flags[0],
                                  is_delta=flags[1])
    err = compare(store[:J], GA.series_grid(sj, zero, 1, J)[:J],
                  f"phase14 {label} {q}: store mode vs plain", rtol=2e-4, atol=1e-4)
    # the aggregate mode (the launch the query makes) per series: every real
    # row its own group, so a series the launch drops or adds twice shows
    # at the store mode's tolerance, not inside a sum of 100k values
    n = entry.block.n_series
    own = torch.full_like(gids, n)
    own[:n] = torch.arange(n, device=gids.device)
    per = AGG.rung_aggregate(rung)(func, "sum", entry.block, own, n, params,
                                   is_counter=flags[0], is_delta=flags[1])[:, :J]
    err = max(err, compare(per, sj[:n, :J], f"phase14 {label} {q}: aggregate mode per "
                           f"series (G = {n}) vs plain", rtol=2e-4, atol=1e-4))
    del per
    # the aggregate against plain's values summed in f64: 100k f32 values of
    # 1e9 (raw counters) summed by atomics in any order are good to ~n eps
    want = AGG.segment_aggregate(ex.op, sj.double(), gids, G + 1)[:G, :J]
    got = torch.as_tensor(runs[1][1], device=want.device)
    compare(got.double(), want, f"phase14 {label} {q} vs plain (f64 sums)", rtol=5e-3)
    if func == "count_over_time":  # integer counts below 2^24: exact in any order
        require(torch.equal(torch.nan_to_num(got.double(), nan=-1.0),
                            torch.nan_to_num(want, nan=-1.0)),
                f"phase14 {label} {q}: the counts differ from plain's")
    compare(torch.as_tensor(runs[0][1], device=want.device), got, f"phase14 {q} first vs warm",
            rtol=5e-3)
    other = AGG.general_rung(func)
    other_out = AGG.rung_aggregate(other)(func, ex.op, entry.block, gids, G, params,
                                          is_counter=entry.is_counter,
                                          is_delta=entry.is_delta)[:, :J]
    compare(got, other_out, f"phase14 {label} {q} vs the {other} rung", rtol=5e-3)
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    acc, cnt = GA.accumulators(ex.op, G, pad_steps(J), want.device)
    acc2, cnt2 = GA.accumulators(ex.op, G, pad_steps(J), want.device)
    new = jitter_launch(rung, func, entry.block, gids, G, params, *flags, ex.op, acc, cnt)
    launch = WS._launch_range if other == "window_stats" else GR._launch
    old = lambda: launch(func, ex.op, entry.block, gids, G, params, *flags, acc2, cnt2)  # noqa: E731
    gpu_sample(f"phase14 {label} {q!r} before")
    times = {"new": [], "old": []}
    for which in ("new", "old", "new", "old"):
        times[which].append(back_to_back_ms(new if which == "new" else old, reps=20))
    kernel_ms = cuda_ms(new, reps=20)
    gpu_sample(f"phase14 {label} {q!r} after")
    plain_ms = cuda_ms(lambda: AGG.apply_epilogue(AGG.rung_series_plain(
        rung, func, entry.block, params, *flags), ("agg", ex.op), gids, G), reps=1, warmup=0)
    n = entry.block.n_series
    bound_bytes = jitter_bound_bytes(rung, func, entry.block, n, J, *flags) + 2 * G * J * 4
    row = {"rung": rung, "first_ms": runs[0][2] * 1e3, "warm_ms": runs[1][2] * 1e3,
           "first_outcome": "build" if runs[0][0].stats.cache_misses else "hit",
           "max_abs_err": err, "kernel_ms": kernel_ms, "kernel_ms_back_to_back": times["new"],
           "replaced_rung": other, "replaced_ms_back_to_back": times["old"],
           "plain_ms": plain_ms, "bound_bytes": bound_bytes,
           "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3, "launches": 2}
    print(f"phase14 {label} {q!r}: grid {want_class}, rung {rung}, one launch a run; first "
          f"({row['first_outcome']}) {row['first_ms']:.1f} ms, warm {row['warm_ms']:.1f} ms; "
          f"store mode and aggregate mode at G = S equal plain per series (max_abs_err "
          f"{err:.3g}, rtol 2e-4 / atol 1e-4), [G, J] plain's f64 "
          f"sums and the {other} rung (rtol 5e-3: f32 atomic sums of 100k values); "
          f"{'counts exact; ' if func == 'count_over_time' else ''}"
          f"{RUNGS[rung]} {kernel_ms:.4f} ms (median of 20), back to back "
          f"{times['new'][0]:.4f} / {times['new'][1]:.4f} against {other} "
          f"{times['old'][0]:.4f} / {times['old'][1]:.4f} alternating; bound "
          f"{row['bound_ms']:.4f} ms ({bound_bytes} bytes), plain {plain_ms:.2f} ms on {card}")
    return row


def phase_fused_jitter(device, card: str, regular_p50_ms: float):
    """Phase 14: bench.py's ``fused_jitter`` stores through the port at full
    width: ``FUSED_JITTER_SERIES`` counters on 8 shards, 720 samples at 10 s, jitter 0.05,
    phase 5 s, seed 42, with no missed scrape (``jitter5pct``: grid class
    ``jitter``) and 1 % missed (``jitter_holes``: ``holes``). Each of
    ``FUSED_JITTER_QUERIES`` first then warm (``fused_jitter_query``); the
    sum(rate) against bench.py's f64 oracle (``oracle_sum_rate``, rtol
    5e-3); the warm p50 of sum(rate) over ``WARM_P50_RUNS`` runs against
    phase 5's regular store's (bench.py's ratio); the holey store's cold
    first query with its sidecar's build timed. Returns the phase's rows
    and the jittered store, which phase 6b extends."""
    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import staging as ST

    out, keep = {}, None
    for label, holes, want_class, rung in FUSED_JITTER_STORES:
        t0 = time.perf_counter()
        ms = build_memstore(FUSED_JITTER_SERIES, N_SAMPLES, 42, "jitter", hole_frac=holes)
        ingest_s = time.perf_counter() - t0
        engine = QueryEngine(ms, "prometheus")
        # the sidecar's build inside the holey store's first query (the masked
        # rung's first read of its superblock), timed where it runs
        sidecar_s = []
        build_sidecar = ST.masked_of

        def timed_masked_of(*a, **k):
            t1 = time.perf_counter()
            try:
                return build_sidecar(*a, **k)
            finally:
                sidecar_s.append(time.perf_counter() - t1)

        ST.masked_of = timed_masked_of
        rows = {}
        try:
            for q, kind in FUSED_JITTER_QUERIES:
                rows[q] = fused_jitter_query(engine, q, kind, want_class, rung, card, label)
        finally:
            ST.masked_of = build_sidecar
        oracle = oracle_sum_rate(ms)
        got = engine.query_range(QUERIES[0], START_S, END_S, STEP_S).grids[0].values_np()[0]
        require(np.allclose(got, oracle, rtol=5e-3),
                f"phase14 {label}: sum(rate) differs from bench.py's f64 oracle")
        oracle_rel = float(np.max(np.abs(got - oracle) / np.abs(oracle)))
        warm = []
        for _ in range(WARM_P50_RUNS):
            t1 = time.perf_counter()
            engine.query_range(QUERIES[0], START_S, END_S, STEP_S).grids[0].values_np()
            warm.append(time.perf_counter() - t1)
        p50 = float(np.median(warm)) * 1e3
        entry = exec_node(engine, QUERIES[0]).superblock(engine.context())
        stage_s = rows[QUERIES[0]]["first_ms"] / 1e3  # the first query's cold build
        res = {"ingest_s": ingest_s, "queries": rows, "oracle_max_rel": oracle_rel,
               "warm_p50_ms": p50, "p50_over_regular": p50 / regular_p50_ms,
               "cold_staging_s": stage_s, "superblock_bytes": ST.staged_nbytes(entry.block)}
        if rung == "masked":
            require(bool(sidecar_s) and entry.block.mgrid is not None,
                    "phase14: the holey superblock's sidecar was not built")
            res["sidecar_build_s"] = sidecar_s[0]
            res["sidecar_bytes"] = entry.block.mgrid.nbytes()
        out[label] = res
        print(f"phase14 {label}: {FUSED_JITTER_SERIES} series ingested in {ingest_s:.1f} s; "
              f"sum(rate) "
              f"matches bench.py's f64 oracle (max rel {oracle_rel:.3g}, rtol 5e-3); warm p50 "
              f"{p50:.2f} ms over {WARM_P50_RUNS} runs, {p50 / regular_p50_ms:.2f} x the regular "
              f"100k store's {regular_p50_ms:.2f} ms (phase 5); cold first query {stage_s:.2f} s, "
              f"superblock {res['superblock_bytes']} bytes"
              + (f", of which the sidecar's build {res['sidecar_build_s']:.2f} s and "
                 f"{res['sidecar_bytes']} bytes" if rung == "masked" else "")
              + f" on {card}")
        if rung == "jitter":
            keep = ms
        del engine, ms
    return out, keep


def jitter_kernel_rows(phase2g: dict, phase14: dict, live_jit: dict, reg_row: dict,
                       tree: dict, subqueries: dict) -> list:
    """The kernels line's rows of this slice: the regular kernel's B5 codes
    (timed on phase 5's superblock; launched by phase 10's regular
    predict_linear and phase 13's outer max_over_time and deriv, also in
    regular_range's count) and the jitter kernel's two variants (timed by
    phase 14's sum(rate); launched by phases 14 and 6b)."""
    b5 = reg_row["b5"]
    b5_launches = sum(row["launches"] for q, row in tree["regular"].items()
                      if row["rung"] == "mxu" and q.split("(")[0] in B5_FUNCS)
    b5_launches += sum(row.get("b5_launches", 0) for per in subqueries.values()
                       for row in per.values() if isinstance(row, dict))
    rows = [{
        "name": "regular_range B5 codes", "route": "cuda",
        "source": "filodb_tpu_torch/csrc/regular_range.cu",
        "replaces": "filodb_tpu/ops/mxu_kernels.py:400",
        "replaces_also": ["filodb_tpu/ops/mxu_kernels.py:364", "filodb_tpu/ops/mxu_kernels.py:371",
                          "filodb_tpu/ops/mxu_kernels.py:304"],
        "launches": b5_launches,
        "max_abs_err": max([phase2g["b5_max_abs_err"]] + [b5[f]["max_abs_err"]
                                                          for f in B5_FUNCS]),
        "ms": b5["predict_linear"]["ms"], "plain_ms": b5["predict_linear"]["plain_ms"],
        "bound_ms": b5["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "library_call": "none: no torch call computes these windowed functions",
        "ms_back_to_back": b5["predict_linear"]["ms_back_to_back"],
        "ms_is": "predict_linear in store mode on phase 5's superblock (100k series x 111 steps)",
        "per_code": {f: b5[f] for f in B5_FUNCS},
    }]
    for name, label, variant, key in (("jitter_range", "jitter5pct", "jitter", "jitter"),
                                      ("masked_range", "jitter_holes", "masked", "masked")):
        per = phase14[label]["queries"]
        first = per[QUERIES[0]]
        launches = sum(r["launches"] for r in per.values() if r["rung"] == variant)
        launches -= sum(2 for q, r in per.items() if r["rung"] == variant
                        and q.startswith("topk"))  # an epilogue's order-statistics launches
        if variant == "jitter":
            launches += live_jit["launches"]
        rows.append({
            "name": name, "route": "cuda", "source": "filodb_tpu_torch/csrc/jitter_range.cu",
            "replaces": "filodb_tpu/ops/mxu_jitter.py:236" if variant == "jitter"
            else "filodb_tpu/ops/mxu_jitter.py:478",
            "replaces_also": ["filodb_tpu/ops/mxu_jitter.py:428" if variant == "jitter"
                              else "filodb_tpu/ops/mxu_jitter.py:709"],
            "launches": launches,
            "max_abs_err": max([phase2g[f"{key}_max_abs_err"]]
                               + [r["max_abs_err"] for r in per.values()
                                  if r["rung"] == variant and "max_abs_err" in r]),
            "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "library_call": "none: no torch call computes these windowed functions",
            "ms_back_to_back": first["kernel_ms_back_to_back"],
            "replaced_rung": first["replaced_rung"],
            "replaced_ms_back_to_back": first["replaced_ms_back_to_back"],
            "ms_is": f"{QUERIES[0]}, phase 14, {label}",
        })
    return rows


# -- phases 15, 15b and 16: the server, the CLI and the histogram jitter mode ----

HTTP_RANGE_QUERIES = (
    QUERIES[0],
    QUERIES[1],
    "topk(5, rate(http_requests_total[5m]))",
    'rate(http_requests_total{instance=~"host-1[0-9]{3}"}[5m])',  # 1000 series: the tree
)
HTTP_RUNS = 5  # warm runs per request for the p50s
REMOTE_SERIES, REMOTE_SAMPLES = 1_000, 10


def http_call(base: str, path: str, data: bytes | None = None, headers: dict | None = None,
              timeout: float = 300.0):
    """One request; returns (status, headers, body, wall seconds). A status
    of 400 and above is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, headers=headers or {},
                                 method="POST" if data is not None else "GET")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, dict(r.headers), body, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read(), time.perf_counter() - t0


def http_json(base: str, path: str, **kw):
    status, headers, body, wall = http_call(base, path, **kw)
    require(status == 200, f"{path}: HTTP {status} {body[:300]!r}")
    return json.loads(body), headers, wall


def server_timing(headers: dict) -> dict:
    """The Server-Timing header's phases, in ms."""
    out = {}
    for part in (headers.get("Server-Timing") or "").split(","):
        name, _, dur = part.strip().partition(";dur=")
        if name:
            out[name] = float(dur)
    return out


def public_labels(labels: dict) -> tuple:
    from filodb_tpu_torch.core.schemas import METRIC_TAG

    return tuple(sorted(("__name__" if k == METRIC_TAG else k, v) for k, v in labels.items()
                        if not k.startswith("__comp__")))


def engine_rows(res) -> dict:
    """An engine answer as the renderer sees it: labels -> (ms timestamps,
    values) of its non-NaN steps."""
    out = {}
    for g in res.grids:
        vals, times = g.values_np(), g.step_times_ms()
        for lbls, row in zip(g.labels, vals):
            keep = ~np.isnan(row)
            if keep.any():
                out[public_labels(lbls)] = (times[keep], row[keep].astype(np.float64))
    return out


def http_rows(payload: dict) -> dict:
    out = {}
    for r in payload["data"]["result"]:
        pts = r["values"] if "values" in r else [r["value"]]
        out[tuple(sorted(r["metric"].items()))] = (
            np.array([round(float(t) * 1000) for t, _ in pts], np.int64),
            np.array([float(v) for _, v in pts], np.float64))
    return out


def rows_equal_http(got: dict, want: dict, what: str, rtol: float = 1e-5) -> float:
    """Labels and timestamps exact, values within rtol (the NaN steps are
    the ones the renderer leaves out). Returns the largest relative
    difference."""
    require(set(got) == set(want), f"{what}: label sets differ ({len(got)} vs {len(want)})")
    worst = 0.0
    for k, (t, v) in want.items():
        gt, gv = got[k]
        require(np.array_equal(gt, t), f"{what} {k}: timestamps differ")
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(gv - v) / np.maximum(np.abs(v), 1e-30)
        require(bool(np.all((np.abs(gv - v) <= rtol * np.abs(v)) | (gv == v))),
                f"{what} {k}: values outside rtol {rtol}")
        worst = max(worst, float(np.max(rel, initial=0.0)))
    return worst


def p50(xs) -> float:
    return float(np.median(xs))


def phase_http(engine, card: str) -> dict:
    """15: the port's HTTP server (``api/http.serve_background``) over
    phase 5's engine on the card. Every answer is held against the engine
    called directly; each request's warm p50 over HTTP beside the engine's,
    with the server's split (Server-Timing: plan, execute -- the launch and
    the rest of the plan's run --, transfer from the device, render) and
    the socket's share (the client's wall less the server's)."""
    import urllib.parse

    from filodb_tpu_torch.api import prompb, snappy
    from filodb_tpu_torch.api.http import serve_background
    from filodb_tpu_torch.core.schemas import METRIC_TAG

    srv, port = serve_background(engine, port=0)
    base = f"http://127.0.0.1:{port}"
    out: dict = {"queries": {}}
    try:
        grid = f"&start={START_S}&end={END_S}&step={STEP_S}"
        for q in HTTP_RANGE_QUERIES:
            path = f"/api/v1/query_range?query={urllib.parse.quote(q)}{grid}"
            http_json(base, path)  # the first through the server: staging, if any
            walls, splits, direct = [], [], []
            for _ in range(HTTP_RUNS):
                payload, headers, wall = http_json(base, path)
                walls.append(wall * 1e3)
                splits.append(server_timing(headers))
                t0 = time.perf_counter()
                res = engine.query_range(q, START_S, END_S, STEP_S)
                want = engine_rows(res)
                direct.append((time.perf_counter() - t0) * 1e3)
            rel = rows_equal_http(http_rows(payload), want, f"phase15 {q}")
            split = {k: p50([s.get(k, 0.0) for s in splits])
                     for k in ("plan", "execute", "transfer", "render")}
            split["socket"] = p50([w - sum(s.values()) for w, s in zip(walls, splits)])
            row = {"http_p50_ms": p50(walls), "direct_p50_ms": p50(direct), "split_ms": split,
                   "series": len(want), "max_rel_err": rel}
            out["queries"][q] = row
            print(f"phase15 {q!r}: {len(want)} series over HTTP equal the engine's (labels and "
                  f"timestamps exact, values rtol 1e-5, max rel {rel:.3g}); warm p50 HTTP "
                  f"{row['http_p50_ms']:.2f} ms vs direct {row['direct_p50_ms']:.2f} ms; split "
                  + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f" ms on {card}")
        t_inst = END_S
        payload, _, wall = http_json(base, f"/api/v1/query?query="
                                           f"{urllib.parse.quote(QUERIES[0])}&time={t_inst}")
        res = engine.query_instant(QUERIES[0], t_inst)
        got = http_rows(payload)
        want = {k: (np.array([round(t_inst * 1000)]), v[-1:]) for k, (t, v) in
                engine_rows(res).items()}
        out["instant_max_rel_err"] = rows_equal_http(got, want, "phase15 instant")
        out["instant_ms"] = wall * 1e3
        names, _, _ = http_json(base, "/api/v1/labels")
        want_names = sorted("__name__" if n == METRIC_TAG else n
                            for n in engine.label_names([], 0, int((time.time() + 1e9) * 1000)))
        require(sorted(names["data"]) == want_names, f"phase15 labels {names['data']}")
        zones, _, _ = http_json(base, "/api/v1/label/zone/values")
        require(zones["data"] == engine.label_values([], "zone", 0,
                                                     int((time.time() + 1e9) * 1000)),
                f"phase15 zone values {zones['data']}")
        match = 'http_requests_total{zone="z3"}'
        series, _, _ = http_json(base, f"/api/v1/series?match[]={urllib.parse.quote(match)}"
                                       f"&limit=10")
        from filodb_tpu_torch.api.http import _matchers_from

        want_series = [dict(public_labels(t)) for t in engine.series(
            _matchers_from(match), 0, int((time.time() + 1e9) * 1000), limit=10)]
        require(series["data"] == want_series and len(want_series) == 10,
                f"phase15 series {series['data'][:2]}")
        # remote write at the live edge (a new metric: the phase-5 superblocks
        # stay as they were), then remote read and a query that sees it
        t_edge = BASE + N_SAMPLES * 10_000
        written = [prompb.TimeSeries(
            [("__name__", "remote_write_demo"), ("instance", f"host-{i}"), ("zone", f"z{i % 8}")],
            [(float(i + k), t_edge + k * 10_000) for k in range(REMOTE_SAMPLES)])
            for i in range(REMOTE_SERIES)]
        body = snappy.compress(prompb.encode_write_request(written))
        t0 = time.perf_counter()
        status, _, _, _ = http_call(base, "/api/v1/write", data=body, headers={
            "Content-Type": "application/x-protobuf", "Content-Encoding": "snappy"})
        write_ms = (time.perf_counter() - t0) * 1e3
        require(status == 204, f"phase15 remote write: HTTP {status}")
        query = prompb.Query(t_edge, t_edge + REMOTE_SAMPLES * 10_000,
                             [prompb.LabelMatcher(0, "__name__", "remote_write_demo")])
        status, _, raw, read_s = http_call(base, "/api/v1/read", data=snappy.compress(
            prompb.encode_read_request([query])))
        require(status == 200, f"phase15 remote read: HTTP {status}")
        (result,) = prompb.decode_read_response(snappy.decompress(raw))
        got = {tuple(sorted(s.labels)): s.samples for s in result}
        want = {tuple(sorted(s.labels)): s.samples for s in written}
        require(got == want, f"phase15 remote read: {len(got)} series, not what was written")
        t_last = (t_edge + (REMOTE_SAMPLES - 1) * 10_000) / 1000
        payload, _, _ = http_json(base, f"/api/v1/query?query=count(remote_write_demo)"
                                        f"&time={t_last}")
        direct = engine.query_instant("count(remote_write_demo)", t_last)
        require(payload["data"]["result"][0]["value"][1] == str(float(REMOTE_SERIES))
                and float(direct.grids[0].values_np()[0, -1]) == REMOTE_SERIES,
                f"phase15 count(remote_write_demo): {payload['data']['result']}")
        prom = "# TYPE smoke_prom_total counter\n" + "\n".join(
            f'smoke_prom_total{{instance="p{i}"}} {i} {t_edge}' for i in range(50))
        payload, _, _ = http_json(base, "/ingest/prom", data=prom.encode(),
                                  headers={"Content-Type": "text/plain"})
        require(payload["data"] == {"ingested": 50}, f"phase15 /ingest/prom {payload}")
        status, _, metrics, _ = http_call(base, "/metrics")
        text = metrics.decode()
        require(status == 200 and "filodb_device_bytes" in text and "filodb_queries_total" in text,
                "phase15 /metrics lacks the ledger's or the engine's families")
        sb, _, _ = http_json(base, "/debug/superblocks")
        res_, _, _ = http_json(base, "/debug/resources")
        kinds = res_["data"]["kinds"]
        cache = engine.memstore._superblock_cache
        require(all(k["drift"] == 0 for k in kinds.values()), f"phase15 ledger drift {kinds}")
        require(sb["data"]["ledger_bytes"] == sb["data"]["bytes"] == cache._walk()
                and kinds["superblock"]["ledger"] == cache._walk(),
                f"phase15 superblock bytes: {sb['data']['ledger_bytes']}, "
                f"{sb['data']['bytes']}, walk {cache._walk()}")
        devices = res_["data"]["devices"]
        require(set(devices.get("superblock", {})) == {"cuda:0"},
                f"phase15 superblock devices {devices}")
        out.update(remote_write_ms=write_ms, remote_read_ms=read_s * 1e3,
                   superblock_bytes=sb["data"]["bytes"], ledger=kinds, devices=devices)
        print(f"phase15: instant {out['instant_ms']:.1f} ms; labels, zone values and a limited "
              f"series request equal the engine's; remote write of {REMOTE_SERIES} x "
              f"{REMOTE_SAMPLES} samples {write_ms:.1f} ms, read back equal in "
              f"{read_s * 1e3:.1f} ms, count() sees them; /ingest/prom 50 rows; ledger drift 0, "
              f"superblock bytes {sb['data']['bytes']} = the cache's walk, devices {devices}")
    finally:
        srv.shutdown()
        srv.server_close()
    return out


CLI_SERIES, CLI_SAMPLES = 50, 60


def phase_cli(card: str) -> dict:
    """15b: ``python -m filodb_tpu_torch.cli serve`` in a subprocess with
    no device flag (it must take the card), ``cli ingest-csv`` of a small
    CSV and ``cli query-range``, held against the same rows through a CPU
    engine; ``/debug/resources`` must show the card."""
    import socket
    import tempfile
    import threading
    from pathlib import Path

    from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
    from filodb_tpu_torch.core.records import gauge_batch
    from filodb_tpu_torch.core.schemas import Dataset
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

    root = Path(__file__).resolve().parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "filodb_tpu_torch.cli", "serve", "--port",
                             str(port)], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list = []
    ready = threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("listening on"):
                ready.set()

    threading.Thread(target=drain, daemon=True).start()
    try:
        require(ready.wait(180), f"phase15b: the server did not start: {''.join(lines)[-2000:]}")
        start_s = time.perf_counter() - t0
        rng = np.random.default_rng(7)
        rows = []
        for i in range(CLI_SERIES):
            v = np.cumsum(rng.uniform(0, 10, CLI_SAMPLES))
            for k in range(CLI_SAMPLES):
                rows.append(("cli_requests_total", f"instance=c{i};zone=z{i % 4}",
                             BASE + k * 15_000, float(v[k])))
        with tempfile.TemporaryDirectory() as tmp:
            csv_path = Path(tmp) / "rows.csv"
            csv_path.write_text("".join(f"{m},{t},{ts},{v!r}\n" for m, t, ts, v in rows))

            def cli(*args):
                out = subprocess.run([sys.executable, "-m", "filodb_tpu_torch.cli", *args,
                                      "--host", base], cwd=root, capture_output=True,
                                     text=True, timeout=300)
                require(out.returncode == 0, f"phase15b cli {args[0]}: {out.stderr[-2000:]}")
                return json.loads(out.stdout)

            t1 = time.perf_counter()
            ingested = cli("ingest-csv", str(csv_path))
            ingest_s = time.perf_counter() - t1
        require(ingested["data"]["ingested"] == len(rows), f"phase15b ingest-csv {ingested}")
        q = "sum by (zone) (rate(cli_requests_total[5m]))"
        start, end, step = (BASE + 400_000) / 1000, (BASE + 800_000) / 1000, 30
        t1 = time.perf_counter()
        got = cli("query-range", q, "--start", str(start), "--end", str(end), "--step",
                  str(step))
        query_s = time.perf_counter() - t1
        # the same rows as the /ingest route stores them, through a CPU engine
        ms = TimeSeriesMemStore()
        ms.setup(Dataset("prometheus"), range(8))
        recs = [({"__name__": m, **dict(kv.split("=") for kv in t.split(";"))}, ts, v)
                for m, t, ts, v in rows]
        ms.ingest_routed("prometheus", gauge_batch("cli_requests_total", recs), spread=3)
        want = QueryEngine(ms, "prometheus", PlannerParams(num_shards=8), device="cpu")
        rel = rows_equal_http(http_rows(got), engine_rows(want.query_range(q, start, end, step)),
                              "phase15b query-range")
        res, _, _ = http_json(base, "/debug/resources")
        dev = res["data"]["engine_device"]
        devices = res["data"]["devices"]
        require(dev.startswith("cuda") and "cuda:0" in devices.get("superblock", {}),
                f"phase15b: the server ran on {dev} ({devices}), not the card")
        print(f"phase15b: cli serve (no device flag) on {dev}, ready in {start_s:.1f} s; "
              f"ingest-csv {len(rows)} rows in {ingest_s:.2f} s; query-range {q!r} equals a CPU "
              f"engine on the same rows (max rel {rel:.3g}) in {query_s:.2f} s; "
              f"/debug/resources devices {devices} on {card}")
        return {"device": dev, "ready_s": start_s, "ingest_s": ingest_s, "query_s": query_s,
                "max_rel_err": rel, "devices": devices}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def cpu_baseline_hist_series(ms) -> np.ndarray:
    """The f64 oracle of the SRE panel over each series' own timestamps
    (``cpu_baseline_hist`` assumes one shared grid): per series and step its
    window's first and last sample by search, the extrapolated per-bucket
    rate, the bucket-wise sum across series, histogram_quantile(0.99): [J]."""
    num_steps = int((END_S - START_S) // STEP_S) + 1
    out_t = np.int64(START_S * 1000) + np.arange(num_steps, dtype=np.int64) * int(STEP_S * 1000)
    parts = [p for s in ms.shard_nums("prometheus")
             for p in ms.shard("prometheus", s).partitions.values()]
    bucket_sum = np.zeros((num_steps, len(HIST_LES)), dtype=np.float64)
    w_s = WINDOW_MS / 1e3
    blk = 2_000
    for b0 in range(0, len(parts), blk):
        pairs = [whole_series(p, "h") for p in parts[b0:b0 + blk]]
        T = np.stack([t for t, _ in pairs]).astype(np.int64, copy=False)
        H = np.stack([h for _, h in pairs]).astype(np.float64, copy=False)
        rows = np.arange(len(pairs))[:, None]
        m = T.shape[1]
        # every row's searches at once: rows sorted apart by an offset of 2^42 ms
        shift = rows << 42
        flat = (T + shift).ravel()
        hi = np.searchsorted(flat, out_t[None, :] + shift, side="right") - rows * m
        lo = np.searchsorted(flat, out_t[None, :] - WINDOW_MS + shift, side="right") - rows * m
        cnt = hi - lo
        lo_c, hi_c = np.minimum(lo, m - 1), np.clip(hi - 1, 0, m - 1)
        tf, tl = T[rows, lo_c] / 1e3, T[rows, hi_c] / 1e3
        sampled = tl - tf
        dur_start = tf - (out_t[None, :] - WINDOW_MS) / 1e3
        dur_end = out_t[None, :] / 1e3 - tl
        avg_dur = sampled / np.maximum(cnt - 1, 1)
        thresh = avg_dur * 1.1
        ds = np.where(dur_start >= thresh, avg_dur / 2, dur_start)
        de = np.where(dur_end >= thresh, avg_dur / 2, dur_end)
        factor = np.where(cnt >= 2, (sampled + ds + de) / np.maximum(sampled, 1e-30), np.nan)
        dlt = H[rows, hi_c] - H[rows, lo_c]
        bucket_sum += np.nansum(dlt * factor[:, :, None] / w_s, axis=0)
    return quantile_of_bucket_sums(bucket_sum, 0.99)


def hist_jitter_bound_bytes(block, params, G: int, wm) -> tuple[int, int]:
    """Bytes the jitter mode must move over the real rows and steps: each
    real row's buckets at the distinct first and last samples of its
    windows with two samples or more (``sample_bytes``), each row's
    timestamps at the distinct edge and first/last slots the step table
    names (read in place), its gid, the step table and acc/cnt written
    once. Returns (bound bytes, sample bytes)."""
    import torch

    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops import mxu_jitter as MJ

    n, J, B = block.n_series, params.num_steps, block.vals.shape[2]
    lo, hi, _ = HK.jitter_windows_plain(block, wm, int(params.window_ms))
    lo, hi = lo[:n, :J], hi[:n, :J]
    two = (hi - lo) >= 2
    pos = torch.cat([torch.where(two, lo, -1), torch.where(two, hi - 1, -1)], dim=1)
    pos = torch.sort(pos, dim=1).values
    new = (pos[:, 1:] != pos[:, :-1]) & (pos[:, 1:] >= 0)
    sample_bytes = (int(new.sum()) + int((pos[:, 0] >= 0).sum())) * B * 4
    d = MJ.step_vectors(wm)
    slots = torch.cat([d["idx"][k][:J] for k in (MJ.F0, MJ.L0, MJ.KLO, MJ.KHI)])
    ts_bytes = n * int(torch.unique(slots).numel()) * 4
    other = ts_bytes + n * 8 + J * MJ.STEP_BYTES + 2 * G * J * B * 4
    return sample_bytes + other, sample_bytes


def phase_hist_jitter(ms, device, card: str) -> dict:
    """16: the SRE panel on bench.py's histograms at bench.py's
    ``fused_jitter`` timestamps (phase 7b's draws): through a server on the
    store's engine (cold, then warm) and through the engine directly, each
    one ``hist_range`` launch in the jitter mode with the quantile folded
    in; [G, J] against the plain path (rtol 1e-3) and an f64 oracle over the
    series' own timestamps (rtol 5e-3); the aggregate mode at G = S per
    series against the plain version (rtol 2e-4 / atol 1e-4); the kernel
    per call and back to back, alternating with ``hist_general`` on the same
    superblock, beside its bound."""
    import urllib.parse

    import torch

    from filodb_tpu_torch.api.http import serve_background
    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops import staging as ST
    from filodb_tpu_torch.ops.kernels import pad_steps

    engine = QueryEngine(ms, "prometheus")
    srv, port = serve_background(engine, port=0)
    base = f"http://127.0.0.1:{port}"
    path = (f"/api/v1/query_range?query={urllib.parse.quote(HIST_QUERY)}&start={START_S}"
            f"&end={END_S}&step={STEP_S}")
    launches = {k: 0 for k in HIST_KERNELS}
    http_ms = {}
    try:
        for label in ("cold", "warm"):
            HK.RANGE_LAUNCHES = HK.JITTER_LAUNCHES = HK.FOLDED_QUANTILES = 0
            payload, headers, wall = http_json(base, path)
            counts = {"hist_range": HK.RANGE_LAUNCHES, "hist_quantile": HK.FOLDED_QUANTILES,
                      "hist_jitter": HK.JITTER_LAUNCHES}
            require(counts == {"hist_range": 1, "hist_quantile": 1, "hist_jitter": 1},
                    f"phase16 HTTP {label}: launches {counts}")
            launches = add_launches(launches, counts)
            http_ms[label] = wall * 1e3
            http_ms[f"{label}_split"] = server_timing(headers)
        direct_ms = []
        for _ in range(HTTP_RUNS):
            res, vals, wall, counts = run_hist(engine, HIST_QUERY, "jitter", "hist_jitter")
            launches = add_launches(launches, counts)
            direct_ms.append(wall * 1e3)
        rel = rows_equal_http(http_rows(payload), engine_rows(res), "phase16 HTTP vs direct")
        sum_res, _, sum_s, counts = run_hist(engine, HIST_SUM_QUERY, "jitter", "hist_jitter",
                                             folds=0)
        launches = add_launches(launches, counts)
    finally:
        srv.shutdown()
        srv.server_close()
    ex = exec_node(engine, HIST_QUERY)
    entry = ex.superblock(engine.context())
    block = entry.block
    got = torch.from_numpy(vals).to(device)
    err = compare(got, hist_plain(entry, ex, 0.99), "16: [G, J] vs the plain path", rtol=1e-3)
    t0 = time.perf_counter()
    ref = cpu_baseline_hist_series(ms)
    oracle_s = time.perf_counter() - t0
    with np.errstate(invalid="ignore"):
        match = np.allclose(vals[0], ref, rtol=5e-3, equal_nan=True)
    require(match, f"16: [G, J] differs from the f64 oracle: {vals[0][:8]} vs {ref[:8]}")
    gids, G, params = path_args(entry, ex)
    wm = AGG._hist_jitter_windows(block, params)
    # the aggregate mode with each series its own group, per series
    S, n = block.vals.shape[0], block.n_series
    gs = torch.full((S,), n, dtype=torch.int64, device=device)
    gs[:n] = torch.arange(n, device=device)
    acc, cnt = HK.hist_range_partials(ex.function, block, gs, n, params, jitter=wm)
    pa, pc = HK.hist_partials_plain(ex.function, block, gs, n, params, jitter=wm)
    require(torch.equal(cnt[:n], pc[:n]), "16: G = S member counts differ from plain")
    per_series = compare(GA.finish_groups("sum", acc, cnt, n), GA.finish_groups("sum", pa, pc, n),
                         "16: G = S per series vs plain", rtol=2e-4, atol=1e-4)
    del acc, cnt, pa, pc, gs
    torch.cuda.empty_cache()
    # the kernel alone, and hist_general on the same superblock, alternating
    J, B = params.num_steps, block.vals.shape[2]
    j_pad = pad_steps(J)
    les = entry.les_dev

    def launcher(jitter):
        plan = HK.hist_plan(block.vals.shape[1], J, B, G, False, jitter=jitter is not None)
        a, c, arr = HK.hist_buffers(G, j_pad * B, plan.slices, device)
        o = torch.full((G, j_pad), float("nan"), dtype=torch.float32, device=device)
        return lambda: HK._launch_range(ex.function, block, gids, G, params, None, False, a, c,
                                        quantile=(0.99, les, o, arr), jitter=jitter)

    jit_launch, gen_launch = launcher(wm), launcher(None)
    gpu_sample("phase16 before")
    j_ms = cuda_ms(jit_launch, reps=20)
    j_b2b, g_b2b = [], []
    for _ in range(2):
        j_b2b.append(back_to_back_ms(jit_launch))
        g_b2b.append(back_to_back_ms(gen_launch))
    g_ms = cuda_ms(gen_launch, reps=20)
    gpu_sample("phase16 after")
    plain_ms = cuda_ms(lambda: HK.hist_partials_plain(ex.function, block, gids, G, params,
                                                      jitter=wm), reps=3, warmup=1)
    bound, sample_bytes = hist_jitter_bound_bytes(block, params, G, wm)
    to_ms = 1e3 / HBM_BYTES_PER_S
    plan = HK.hist_plan(block.vals.shape[1], J, B, G, False, jitter=True)
    row = {"http_cold_ms": http_ms["cold"], "http_warm_ms": http_ms["warm"],
           "http_warm_split_ms": http_ms["warm_split"], "direct_warm_p50_ms": p50(direct_ms),
           "http_vs_direct_max_rel": rel, "sum_by_le_ms": sum_s * 1e3,
           "superblock_bytes": ST.staged_nbytes(block), "max_abs_err": err,
           "per_series_max_abs_err": per_series, "oracle_s": oracle_s,
           "ms": j_ms, "ms_back_to_back": min(j_b2b), "back_to_back_runs": j_b2b,
           "general_ms": g_ms, "general_ms_back_to_back": min(g_b2b),
           "general_back_to_back_runs": g_b2b, "plain_ms": plain_ms,
           "bound_ms": bound * to_ms, "bound_bytes": bound, "sample_bytes": sample_bytes,
           "rows": plan.rows, "partials": plan.partials, "threads": plan.threads,
           "launches": launches}
    print(f"phase16 {HIST_QUERY!r}: grid jitter, variant hist_jitter, {n} series; HTTP cold "
          f"{http_ms['cold']:.1f} ms, warm {http_ms['warm']:.1f} ms (split "
          + ", ".join(f"{k} {v:.2f}" for k, v in http_ms["warm_split"].items())
          + f" ms), direct warm p50 {row['direct_warm_p50_ms']:.2f} ms; one hist_range launch "
          f"in the jitter mode each; [G, J] matches the plain path (max_abs_err {err:.3g}), the "
          f"f64 oracle over per-series timestamps (rtol 5e-3, {oracle_s:.1f} s on the host) and "
          f"the HTTP answer (max rel {rel:.3g}); G = S per series vs plain max_abs_err "
          f"{per_series:.3g}; kernel {j_ms:.4f} ms (median of 20), back to back "
          + " / ".join(f"{x:.4f}" for x in j_b2b) + f" ms vs hist_general {g_ms:.4f} ms, back to "
          f"back " + " / ".join(f"{x:.4f}" for x in g_b2b) + f" ms (alternating); bound "
          f"{bound * to_ms:.4f} ms ({bound} bytes at 3.35 TB/s); plain {plain_ms:.2f} ms "
          f"on {card}")
    del entry
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from filodb_tpu_torch.coordinator.planner import QueryEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    device = torch.device("cuda")
    split_libs = build_kernels()
    card = card_line()
    print(f"phase1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    gpu_sample("phase2 before")
    phase_window_stats_vs_plain(args.seed, device)
    phase_fused_vs_plain(args.seed, device)
    phase_regular_vs_plain(args.seed, device)
    general_err = phase_general_vs_plain(args.seed, device)
    tree_kernels = phase_tree_kernels_vs_plain(args.seed, device)
    tree_aggs_2e = phase_tree_aggregates_vs_plain(args.seed, device)
    hist_2f = phase_hist_tree_vs_plain(args.seed, device)
    jitter_2g = phase_jitter_vs_plain(args.seed, device)
    gpu_sample("phase3 after")
    elapsed("phases 1-3")
    wr_row, ws_row, engine, rate_result = phase_irregular_path(args.seed, device)
    general = phase_general_path(engine, card, rate_result)
    epilogues = phase_epilogues(engine, card, EPILOGUE_IRREGULAR, "irregular")
    elapsed("phases 4, 8, 9 (irregular)")
    tree = {"irregular": phase_tree(engine, card, "irregular", rate_result)}
    elapsed("phase 10 (irregular)")
    tree_agg = {"irregular": phase_tree_aggregates(engine, card, "irregular")}
    agg_kernels = tree_agg_kernels(engine, card, "irregular")
    elapsed("phase 11 (irregular)")
    subqueries = {"irregular": phase_subqueries(engine, card, "irregular")}
    elapsed("phase 13 (irregular)")
    del engine
    gc.collect()  # the irregular store goes before the regular one is built
    torch.cuda.empty_cache()
    reg_row, engine = phase_regular_path(args.seed, device)
    live = phase_live_edge(engine, device, "phase6", "regular", n_idle=10, n_busy=10,
                           min_batches=1, seed=args.seed)
    reg_row["launches"] += live["launches"]
    general_regular = phase_general_regular(engine, card)
    epilogues.update(phase_epilogues(engine, card, EPILOGUE_REGULAR, "regular"))
    reg_rate = engine.query_range(QUERIES[0], START_S, END_S, STEP_S).grids[0].values_np()
    elapsed("phases 5, 6, 8, 9 (regular)")
    tree["regular"] = phase_tree(engine, card, "regular", reg_rate)
    elapsed("phase 10 (regular)")
    tree_agg["regular"] = phase_tree_aggregates(engine, card, "regular")
    elapsed("phase 11 (regular)")
    subqueries["regular"] = phase_subqueries(engine, card, "regular")
    elapsed("phase 13 (regular)")
    http = phase_http(engine, card)
    elapsed("phase 15")
    cli = phase_cli(card)
    elapsed("phase 15b")
    del engine
    gc.collect()  # the regular store goes before the jittered one is built
    torch.cuda.empty_cache()
    order_stream = phase_order_stream(args.seed, device, card)
    gc.collect()
    torch.cuda.empty_cache()
    fused_jitter, jit_store = phase_fused_jitter(device, card, reg_row["warm_p50_ms"])
    elapsed("phase 14")
    gc.collect()
    live_jit = phase_live_edge(QueryEngine(jit_store, "prometheus"), device, "phase6b", "jitter",
                               n_idle=5, n_busy=4, min_batches=1, seed=args.seed)
    elapsed("phase 6b")
    del jit_store
    gc.collect()  # the jittered store goes before the histogram stores are built
    torch.cuda.empty_cache()

    range_err, q_err = phase_hist_vs_plain(args.seed, device)
    bench_hist, hist_engine, jit_hist_store = phase_hist_bench(device, split_libs)
    hist_tree = {"regular": phase_hist_tree(hist_engine, card, "regular", HIST_TREE_QUERIES,
                                            split_libs)}
    elapsed("phases 7a, 7b, 12 (regular)")
    del hist_engine
    gc.collect()  # bench.py's histogram store goes before phase 16's superblock is built
    torch.cuda.empty_cache()
    hist_jitter = phase_hist_jitter(jit_hist_store, device, card)
    elapsed("phase 16")
    del jit_hist_store
    gc.collect()  # the jittered histograms go before the irregular ones are built
    torch.cuda.empty_cache()
    irr_hist, hist_engine = phase_hist_irregular(device, HIST_IRREGULAR_SERIES, split_libs)
    hist_tree["irregular"] = phase_hist_tree(hist_engine, card, "irregular",
                                             HIST_TREE_QUERIES[:2], split_libs)
    elapsed("phases 7c, 12 (irregular)")
    del hist_engine
    gc.collect()  # the irregular store goes before the card block is made
    torch.cuda.empty_cache()
    card_hist = phase_hist_card_block(device, split_libs)
    gc.collect()  # the card block goes before the classic store is built
    torch.cuda.empty_cache()
    classic = phase_classic(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    month = phase_month(device, card)
    elapsed("phases 9b, 6b, 7a-7d, 10b, 10c")
    launches = add_launches(bench_hist["launches"], irr_hist["launches"])
    # phase 16's folded quantiles (its range launches are the hist_jitter row's)
    launches["hist_quantile"] += hist_jitter["launches"]["hist_quantile"]
    for t in hist_tree.values():  # the fused answers phase 12 held the tree against
        for row in t["queries"].values():
            if "fused_launches" in row:
                launches = add_launches(launches, row["fused_launches"])
    hist_rows = [{
        "name": "hist_range",
        "route": "cuda",
        "source": "filodb_tpu_torch/csrc/hist_range.cu",
        "replaces": "filodb_tpu/ops/hist_kernels.py:157",
        "launches": launches["hist_range"],
        "max_abs_err": max(range_err, bench_hist["range_max_abs_err"],
                           irr_hist["range_max_abs_err"], card_hist["range_max_abs_err"]),
        "ms": bench_hist["range_ms"],
        "plain_ms": bench_hist["range_plain_ms"],
        "bound_ms": bench_hist["range_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no torch call computes a windowed, extrapolated per-bucket rate",
        "ms_back_to_back": bench_hist["range_ms_back_to_back"],
        "bound_bytes": bench_hist["range_bound_bytes"],
        "sector_floor_ms": bench_hist["sector_floor_ms"],
        "per_series_bounds": {k: irr_hist[k] for k in (
            "range_ms", "range_ms_back_to_back", "range_plain_ms", "range_bound_ms",
            "sector_floor_ms")},
        "per_series_bounds_100k_card_block": {k: card_hist[k] for k in (
            "range_ms", "range_ms_back_to_back", "range_plain_ms", "range_bound_ms",
            "sector_floor_ms")},
    }, {
        "name": "hist_quantile",
        "route": "folded into hist_range",
        "source": "filodb_tpu_torch/csrc/hist_range.cu",
        "replaces": "filodb_tpu/ops/hist_kernels.py:86",
        "launches": launches["hist_quantile"],
        "max_abs_err": max(q_err, bench_hist["quantile_max_abs_err"],
                           irr_hist["quantile_max_abs_err"], card_hist["quantile_max_abs_err"]),
        "ms": bench_hist["quantile_ms_back_to_back"],
        "plain_ms": bench_hist["quantile_plain_ms"],
        "bound_ms": bench_hist["quantile_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no torch call interpolates histogram_quantile",
        "ms_per_call": bench_hist["quantile_ms"],
        "ms_is": "back to back, a range launch with the quantile folded in less one without it",
    }, {
        "name": "hist_jitter",
        "route": "cuda",
        "source": "filodb_tpu_torch/csrc/hist_range.cu",
        "replaces": "filodb_tpu/ops/hist_kernels.py:207",
        "launches": hist_jitter["launches"]["hist_jitter"],
        "max_abs_err": max(hist_jitter["max_abs_err"], hist_jitter["per_series_max_abs_err"]),
        "ms": hist_jitter["ms"],
        "plain_ms": hist_jitter["plain_ms"],
        "bound_ms": hist_jitter["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no torch call computes a windowed, extrapolated per-bucket rate",
        "ms_back_to_back": hist_jitter["ms_back_to_back"],
        "bound_bytes": hist_jitter["bound_bytes"],
        "hist_general_ms": hist_jitter["general_ms"],
        "hist_general_ms_back_to_back": hist_jitter["general_ms_back_to_back"],
        "ms_is": "the jitter mode with the quantile folded in, phase 16's superblock",
    }]

    first = general[GENERAL_QUERIES[0][0]]
    wr_row["launches"] += general[GENERAL_QUERIES[5][0]]["launches"]
    general_row = {
        "name": "general_range",
        "route": "cuda",
        "source": "filodb_tpu_torch/csrc/general_range.cu",
        "replaces": "filodb_tpu/ops/kernels.py:141",
        "launches": sum(v["launches"] for v in general.values() if v["rung"] == "general")
        + general_regular["launches"],
        "max_abs_err": max([general_err, general_regular["max_abs_err"]]
                           + [v["max_abs_err"] for v in general.values()]),
        "max_abs_err_phase2c": general_err,  # irate over a tied last pair: dv / 1e-30
        "max_abs_err_phase8": max([general_regular["max_abs_err"]]
                                  + [v["max_abs_err"] for v in general.values()]),
        "ms": first["kernel_ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": None,
        "library_call": "none: no torch call computes these windowed functions",
        "ms_back_to_back": first["kernel_ms_back_to_back"],
        "ms_is": f"{GENERAL_QUERIES[0][0]}, phase 8",
        "queries": {**general, f"{REGULAR_GENERAL_QUERY} (regular store)": general_regular},
    }
    print(json.dumps({"cache": {"phase6": live, "phase6b": live_jit}}))
    print(json.dumps({"hist": {"phase7b": bench_hist, "phase7c": irr_hist, "phase7d": card_hist,
                               "phase16": hist_jitter}}))
    print(json.dumps({"server": {"phase15": http, "phase15b": cli}}))
    order_rows = epilogue_rows(epilogues, {"window_stats": wr_row, "general": general_row,
                                           "mxu": reg_row}, order_stream)
    for per in fused_jitter.values():  # phase 14's general leaves and topk order statistics
        for q, r in per["queries"].items():
            if r["rung"] == "general":
                general_row["launches"] += r["launches"]
            if q.startswith("topk"):
                next(o for o in order_rows if o["name"] == "topk_steps")["launches"] += 2
    print(json.dumps({"epilogues": {"phase9": epilogues, "phase9b": order_stream}}))
    jitter_rows = jitter_kernel_rows(jitter_2g, fused_jitter, live_jit, reg_row, tree,
                                     subqueries)
    rung_rows = {"window_stats": wr_row, "mxu": reg_row, "general": general_row,
                 "jitter": jitter_rows[1], "masked": jitter_rows[2]}
    tree_rows = tree_kernel_rows(tree, tree_kernels, classic, rung_rows, subqueries)
    agg_rows = tree_agg_rows(tree_agg, agg_kernels, tree_aggs_2e, rung_rows,
                             order_rows + tree_rows)
    agg_rows[0]["launches"] += sum(t["launches"]["segment_agg"] for t in hist_tree.values())
    hist_rows_12 = hist_tree_rows(hist_tree, hist_2f)
    print(json.dumps({"tree": {"phase2d": tree_kernels, "phase2e": tree_aggs_2e, "phase10": tree,
                               "phase10b": classic, "phase10c": month, "phase11": tree_agg,
                               "phase11_kernels": agg_kernels, "phase13": subqueries}}))
    print(json.dumps({"hist_tree": {"phase2f": hist_2f, "phase12": hist_tree}}))
    print(json.dumps({"jitter": {"phase2g": jitter_2g, "phase14": fused_jitter}}))
    print(json.dumps({"kernels": [ws_row, wr_row, general_row, reg_row, *hist_rows,
                                  *order_rows, *tree_rows, *agg_rows, *hist_rows_12,
                                  *jitter_rows]}))
    elapsed("all phases")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
