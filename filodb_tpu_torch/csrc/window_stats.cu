// Window statistics for irregular series on Hopper (sm_90a): two kernels
// that replace the TPU kernel filodb_tpu/ops/pallas_kernels.py:33
// (_window_agg_kernel, launched by window_aggregates).
//
// 1. window_range_kernel (entry filodb_window_range_aggregate), the main
//    path: the counterpart of filodb_tpu/ops/aggregations.py
//    _fused_pallas_jit, which runs window stats, finish for one range
//    function and the ("agg", op) epilogue behind one jit boundary. One
//    launch computes, for every (row s, step j < J), the range function
//    over the window (t_j - w, t_j] and reduces it into [G, J] group
//    accumulators; no [S, J] plane reaches device memory.
// 2. window_lanes_kernel (entry filodb_window_range_lanes), the lane mode
//    of 1 for cross-query batching: the counterpart of
//    filodb_tpu/ops/aggregations.py:1208 _batched_general_jit where the
//    port serves the function on window stats (design at the kernel).
// 3. window_stats_kernel (entry filodb_window_stats): the nine statistics
//    planes [S, J] of the TPU kernel (count, sum, min, max, first/last
//    timestamp, first/last value, first raw value), for callers that need
//    the per-series grid; it is no longer on the main path.
//
// Design of window_range_kernel. A persistent grid of 256-thread blocks
// walks tiles of R rows (row_tiles.cuh). Each row's samples [0, lens[s])
// of ts and of the arrays the function reads -- vals, and raw only for
// the counter zero-crossing cap -- are staged into shared memory with
// double-buffered cp.async copies, so the next tile's bytes are in flight
// while this one is computed; rows of the trash group copy nothing. The
// block's threads take the tile's (row, step) pairs flattened row by row,
// so every lane has a pair whatever J is (only the tile's last wave is
// partial). A pair finds its window with two binary searches in the
// shared-memory row (the second only over [0, hi)), then scans only what
// its function needs, chosen by the template argument: nothing more for
// count/present/absent, the sum for sum/avg_over_time (and rate/increase
// on delta columns), min or max, the tied run at one end for first/last,
// and for rate/increase/delta the runs at both ends (values, and raw at
// the first). finish (ops/window_stats.py) is computed inline, line for
// line, and the value reduces through group_acc.cuh: shared-memory group
// partials flushed once per block while 2*G*J*4 bytes fit the wrapper's
// budget, else global atomics. The wrapper decides how many arrays a
// launch stages (n_arrays; the entry refuses too few for the function);
// rows wider than the shared-memory budget are read in place from device
// memory (n_arrays = 0, STAGED = false), the same code on other pointers.
// Store mode (acc_op ACC_STORE, the variant STORE: the fused epilogues
// topk/bottomk/quantile) writes each (row, step < J) value once, NaN
// included, to the step-major [J_pad, S] grid `acc` instead
// (group_acc.cuh Store; rows of the trash group as NaN); no partials.
//
// Bound of window_range_kernel: device-memory bytes -- each real sample's
// ts, value and raw value read once, lens and gids, the [G, J] outputs --
// 829 MB on the main path (0.2475 ms at 3.35 TB/s); a few dozen integer
// and float operations per (row, step).
//
// Design of window_stats_kernel. The TPU kernel scans all T samples of a
// 64-row tile for each of 128 steps and accumulates one-hot columns in
// VMEM. Here rows are sorted
// (staging packs strictly increasing timestamps and pads with INT32_MAX
// past lens[s]), so one thread per (row, step) finds its window with two
// binary searches over [0, lens[s]) and then visits only the samples inside
// it. Threads of a warp take neighbouring steps of one row, so the nine
// [S, J] stores coalesce and the row's samples are shared through L1/L2.
//
// Bound. The kernel moves the block (ts, vals, raw: 12 bytes a sample) and
// writes 36 bytes per (row, step); it does a handful of compares per
// sample, so it is bound by device-memory bytes (3.35 TB/s on an H100 SXM).
// Overlapping windows re-read samples from cache, not from device memory,
// as long as a row's window span stays resident.
//
// Semantics both kernels keep from the TPU kernel: time math in int32 with
// wrap-around, first/last timestamps selected as int32 and cast to f32,
// NaN values confined to the windows that hold them (per-window
// accumulation), and the empty-window sentinels below (the fused kernel's
// finish turns every empty window into NaN, or 1 for absent_over_time,
// before a sentinel is read). First/last values
// follow the TPU kernel's pick-by-timestamp: v_first and raw_first sum every
// in-window value whose timestamp equals the window's first timestamp, and
// v_last every one equal to its last. Rows are sorted, so the ties are a
// run at each end of [lo, hi): a scan forward from lo and back from hi-1
// that stops at the first other timestamp (one extra compare for strictly
// increasing rows, which is what staging from the memstore gives).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"
#include "row_tiles.cuh"
#include "window_search.cuh"

namespace {

using window_search::count_le;
using window_search::lower_edge;
using window_search::wrap_add;
using window_search::wrap_mul;

constexpr float POS = 3.0e38f;
constexpr float NEG = -3.0e38f;
constexpr int32_t IMAX = 2147483647;
constexpr int32_t IMIN = -2147483647;

__global__ void window_stats_kernel(
    const int32_t* __restrict__ ts, const float* __restrict__ vals,
    const float* __restrict__ raw, const int32_t* __restrict__ lens,
    int S, int T, int J, int32_t start, int32_t step, int32_t window,
    float* __restrict__ cnt_o, float* __restrict__ sum_o,
    float* __restrict__ min_o, float* __restrict__ max_o,
    float* __restrict__ tf_o, float* __restrict__ tl_o,
    float* __restrict__ vf_o, float* __restrict__ vl_o,
    float* __restrict__ rf_o) {
    int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (int64_t)S * J) return;
    int s = (int)(idx / J);
    int j = (int)(idx - (int64_t)s * J);
    int n = __ldg(lens + s);
    n = n < 0 ? 0 : (n > T ? T : n);
    const int32_t* row_t = ts + (int64_t)s * T;
    const float* row_v = vals + (int64_t)s * T;
    const float* row_r = raw + (int64_t)s * T;

    int32_t t_j = wrap_add(start, wrap_mul(j, step));
    int32_t t_lo = wrap_add(t_j, -window);
    int hi = count_le<true>(row_t, n, t_j);
    int lo = count_le<true>(row_t, n, t_lo);
    if (lo > hi) lo = hi;  // empty window (w <= 0 or wrapped bounds)

    float sum = 0.0f, mn = POS, mx = NEG;
    for (int k = lo; k < hi; ++k) {
        float v = __ldg(row_v + k);
        sum += v;
        // NaN propagates as in jnp.min / jnp.max
        mn = (isnan(v) || v < mn) ? v : mn;
        mx = (isnan(v) || v > mx) ? v : mx;
    }
    int32_t t_first = IMAX, t_last = IMIN;
    float vf = 0.0f, vl = 0.0f, rf = 0.0f;
    if (hi > lo) {
        t_first = __ldg(row_t + lo);
        t_last = __ldg(row_t + hi - 1);
        for (int k = lo; k < hi && __ldg(row_t + k) == t_first; ++k) {
            vf += __ldg(row_v + k);
            rf += __ldg(row_r + k);
        }
        int kb = hi - 1;  // start of the run tied at the last timestamp
        while (kb > lo && __ldg(row_t + kb - 1) == t_last) --kb;
        for (int k = kb; k < hi; ++k) vl += __ldg(row_v + k);
    }
    cnt_o[idx] = (float)(hi - lo);
    sum_o[idx] = sum;
    min_o[idx] = mn;
    max_o[idx] = mx;
    tf_o[idx] = (float)t_first;
    tl_o[idx] = (float)t_last;
    vf_o[idx] = vf;
    vl_o[idx] = vl;
    rf_o[idx] = rf;
}

// ---- the fused kernel: window stats -> finish -> group aggregate ----

using row_tiles::THREADS;

// range functions (ops/window_stats.py WINDOW_FUNC_CODES)
enum WFunc {
    W_SUM_OVER_TIME = 0, W_COUNT_OVER_TIME, W_AVG_OVER_TIME, W_MIN_OVER_TIME,
    W_MAX_OVER_TIME, W_LAST, W_FIRST_OVER_TIME, W_PRESENT_OVER_TIME,
    W_ABSENT_OVER_TIME, W_RATE, W_INCREASE, W_DELTA,
};
// what a function scans in its window: the kernel's template argument
enum Kind { K_COUNT = 0, K_SUM, K_MIN, K_MAX, K_FIRST, K_LAST, K_EXTRAP };

struct RangeArgs {
    const int32_t* ts;
    const float* vals;
    const float* raw;
    const int32_t* lens;
    const long long* gids;
    int S, T, J, ld, G;
    int32_t start, step, window;
    int func, acc_op;
    int zero_cap;  // rate/increase of a counter: the zero-crossing cap reads raw
    int R;         // rows per tile
    int n_arrays;  // arrays staged per row (ts, vals, raw in order); 0: read in place
    float* acc;
    float* cnt;
};

// finish (ops/window_stats.py) of one (row, step), line for line: the
// function of the window (t_j - w, t_j] over the row's first n samples.
template <int KIND>
__device__ __forceinline__ float window_value(const RangeArgs& a, const int32_t* rt,
                                              const float* rv, const float* rr, int n, int j) {
    const float NaN = group_acc::nan_f();
    const int32_t t_j = wrap_add(a.start, wrap_mul(j, a.step));
    const int hi = count_le(rt, n, t_j);
    const int lo = lower_edge(rt, hi, wrap_add(t_j, -a.window));
    const bool has = hi > lo;
    const float cnt = (float)(hi - lo);
    if (KIND == K_COUNT) {
        if (a.func == W_COUNT_OVER_TIME) return has ? cnt : NaN;
        if (a.func == W_PRESENT_OVER_TIME) return has ? 1.0f : NaN;
        return has ? NaN : 1.0f;  // absent_over_time
    }
    if (!has) return NaN;
    const float wf = (float)a.window;
    if (KIND == K_SUM) {  // sum/avg_over_time; rate/increase on delta columns
        float sm = 0.0f;
        for (int k = lo; k < hi; ++k) sm += rv[k];
        if (a.func == W_AVG_OVER_TIME) return sm / fmaxf(cnt, 1.0f);
        if (a.func == W_RATE) return sm / (wf * 1e-3f);
        return sm;
    }
    if (KIND == K_MIN || KIND == K_MAX) {  // NaN propagates as in torch.amin / amax
        float m = KIND == K_MIN ? POS : NEG;
        for (int k = lo; k < hi; ++k) {
            const float v = rv[k];
            m = (isnan(v) || (KIND == K_MIN ? v < m : v > m)) ? v : m;
        }
        return m;
    }
    // tied runs at the window's ends: every value at the first (last)
    // timestamp is summed, as the TPU kernel does
    const int32_t t_first = rt[lo];
    float vf = 0.0f, rf = 0.0f;
    if (KIND != K_LAST) {
        for (int k = lo; k < hi && rt[k] == t_first; ++k) {
            vf += rv[k];
            if (KIND == K_EXTRAP && a.zero_cap) rf += rr[k];
        }
        if (KIND == K_FIRST) return vf;
    }
    const int32_t t_last = rt[hi - 1];
    int kb = hi - 1;
    while (kb > lo && rt[kb - 1] == t_last) --kb;
    float vl = 0.0f;
    for (int k = kb; k < hi; ++k) vl += rv[k];
    if (KIND == K_LAST) return vl;
    // rate / increase / delta: Prometheus extrapolation. The products that
    // feed a difference are __fmul_rn, which nvcc never contracts into an
    // FMA: this function is inlined into the solo and the lane kernels, and
    // a contraction in one and not the other moved a window's end by an ulp
    // of its time in seconds (~0.24 ms at 2,800 s), a 2-sample increase by
    // 2.4e-5 of itself; rounded the same way, the two kernels agree bit for
    // bit
    if (hi - lo < 2) return NaN;
    const float INF = group_acc::inf_f();
    const float out_t = (float)t_j;
    const float tf = __fmul_rn((float)t_first, 1e-3f);
    const float tl = __fmul_rn((float)t_last, 1e-3f);
    const float dlt = vl - vf;
    const float sampled = tl - tf;
    float dur_start = tf - __fmul_rn(out_t - wf, 1e-3f);
    float dur_end = __fmul_rn(out_t, 1e-3f) - tl;
    const float avg_dur = sampled / fmaxf(cnt - 1.0f, 1.0f);
    const float thresh = avg_dur * 1.1f;
    if (a.zero_cap) {
        const float dur_zero = dlt > 0.0f ? sampled * (rf / fmaxf(dlt, 1e-30f)) : INF;
        dur_start = group_acc::nan_min(dur_start, rf >= 0.0f ? dur_zero : INF);
    }
    dur_start = dur_start >= thresh ? avg_dur / 2.0f : dur_start;
    dur_end = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
    const float factor = (sampled + dur_start + dur_end) / fmaxf(sampled, 1e-30f);
    const float res = dlt * factor;
    return a.func == W_RATE ? res / (wf * 1e-3f) : res;
}

template <int KIND, bool STAGED, bool SHARED, bool STORE>
__global__ void __launch_bounds__(THREADS) window_range_kernel(const RangeArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int part = SHARED ? a.G * a.J : 0;
    float* acc_s = smem;
    float* cnt_s = smem + part;
    float* stage = smem + ((2 * part + 3) & ~3);  // 16-byte aligned
    const int R = a.R, T = a.T;
    const int narr = a.n_arrays;
    const int64_t buf_words = (int64_t)narr * R * T;
    const group_acc::Sink sink = SHARED ? group_acc::Sink{acc_s, cnt_s, a.J, a.acc_op}
                                        : group_acc::Sink{a.acc, a.cnt, a.ld, a.acc_op};
    const group_acc::Store store{a.acc, a.S};
    if (SHARED) {
        group_acc::shared_init(acc_s, cnt_s, part, a.acc_op);
        __syncthreads();
    }
    auto issue = [&](int tile, int b) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::issue_tile(a.ts, a.vals, a.raw, narr, s0, min(R, a.S - (int)s0), R, T,
                              stage + b * buf_words, [&](int r) {
                                  // a partial last tile copies no row past S
                                  // (the store variants' bound, below)
                                  if (s0 + r >= a.S) return 0;
                                  const long long g = __ldg(a.gids + s0 + r);
                                  if (g < 0 || g >= a.G) return 0;
                                  const int n = min(max(__ldg(a.lens + s0 + r), 0), T);
                                  return (n + 3) >> 2;
                              });
    };
    row_tiles::for_each_tile<STAGED>(a.S, R, issue, [&](int tile, int b) {
        const int64_t s0 = (int64_t)tile * R;
        const float* buf = stage + b * buf_words;
        row_tiles::for_each_pair(min(R, a.S - (int)s0), a.J, [&](int r, int j) {
            const int64_t s = s0 + r;
            // nvcc 12.8 (sm_90a) compiles the store variants' min(R, S - s0)
            // without its negation, so a partial last tile ran all R rows
            // and wrote past the grid's rows; the bound is checked again
            if (STORE && s >= a.S) return;
            const long long g = __ldg(a.gids + s);
            if (g < 0 || g >= a.G) {  // trash group G (padding) or no group
                if (STORE) store.put(s, j, group_acc::nan_f());
                return;
            }
            const int n = min(max(__ldg(a.lens + s), 0), T);
            const int32_t* rt;
            const float* rv;
            const float* rr;
            if (STAGED) {
                rt = (const int32_t*)(buf + (int64_t)r * T);
                rv = buf + (int64_t)(R + r) * T;
                rr = buf + (int64_t)(2 * R + r) * T;
            } else {
                rt = a.ts + s * T;
                rv = a.vals + s * T;
                rr = a.raw + s * T;
            }
            const float v = window_value<KIND>(a, rt, rv, rr, n, j);
            if (STORE) store.put(s, j, v);
            else if (!isnan(v)) sink.add(g, j, v);
        });
    });
    if (SHARED) {
        __syncthreads();
        group_acc::shared_flush(acc_s, cnt_s, a.G, a.J, a.acc, a.cnt, a.ld, a.acc_op);
    }
}

template <int KIND, bool STAGED, bool SHARED, bool STORE = false>
int launch_range(const RangeArgs& a, int smem, cudaStream_t stream) {
    auto kern = window_range_kernel<KIND, STAGED, SHARED, STORE>;
    int grid = 0;
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, (a.S + a.R - 1) / a.R, &grid);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const RangeArgs& a, int shared, int smem, cudaStream_t st) {
    if (a.acc_op == group_acc::ACC_STORE)
        return a.n_arrays > 0 ? launch_range<KIND, true, false, true>(a, smem, st)
                              : launch_range<KIND, false, false, true>(a, smem, st);
    if (a.n_arrays > 0)
        return shared ? launch_range<KIND, true, true>(a, smem, st)
                      : launch_range<KIND, true, false>(a, smem, st);
    return shared ? launch_range<KIND, false, true>(a, smem, st)
                  : launch_range<KIND, false, false>(a, smem, st);
}

// the scan a function needs (finish's first branch takes rate/increase
// on delta columns as window sums)
int kind_of(int func, int is_delta) {
    switch (func) {
        case W_COUNT_OVER_TIME: case W_PRESENT_OVER_TIME: case W_ABSENT_OVER_TIME: return K_COUNT;
        case W_SUM_OVER_TIME: case W_AVG_OVER_TIME: return K_SUM;
        case W_MIN_OVER_TIME: return K_MIN;
        case W_MAX_OVER_TIME: return K_MAX;
        case W_FIRST_OVER_TIME: return K_FIRST;
        case W_LAST: return K_LAST;
        case W_RATE: case W_INCREASE: return is_delta ? K_SUM : K_EXTRAP;
        case W_DELTA: return K_EXTRAP;
        default: return -1;
    }
}

// ---- lane mode (cross-query batching, B12) ----
//
// One launch serves L lanes over U unique windows. A persistent block walks
// tiles of R rows as window_range_kernel does and stages each tile's rows
// once (double-buffered cp.async, only rows some lane groups); the staged
// tile then serves every window u in turn: the block's threads take the
// tile's (row, step) pairs, compute window u's value once (window_value,
// the solo kernel's function) and fold it into every lane of u at the
// lane's group (group_acc.cuh lanes::). The lanes are listed by window in
// shared memory (window u's from off_s[u]); all L lanes' [G, J] partials
// stay in shared memory while 2 L G J floats fit the wrapper's budget
// beside the staging buffers (ops/group_acc.tile_plan, lanes = L), else
// every value goes to the lanes' global arrays with atomics. STORE: each
// window's [ld, S] grid at acc + u ld S, rows outside the group of gids[0]
// NaN. Bound: each real sample's staged arrays read once for all U
// windows, L S 4 bytes of gids, the lanes' [G, J] acc/cnt.

template <int KIND, bool STAGED, bool SHARED, bool STORE>
__global__ void __launch_bounds__(THREADS) window_lanes_kernel(
    const RangeArgs a0, const lanes::Table t, const int32_t* __restrict__ start,
    const int32_t* __restrict__ step, const int32_t* __restrict__ window, int U) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int lane_s[lanes::MAX_LANES];
    __shared__ int off_s[lanes::MAX_LANES + 1];
    const int64_t n_part = (int64_t)t.G * a0.J;  // one lane's acc (or cnt) words
    const int64_t part = SHARED ? 2 * t.L * n_part : 0;
    float* stage = smem + ((part + 3) & ~3);  // 16-byte aligned
    const int R = a0.R, T = a0.T;
    const int narr = a0.n_arrays;
    const int64_t buf_words = (int64_t)narr * R * T;
    if (threadIdx.x == 0) {
        int k = 0;
        for (int u = 0; u < U; ++u) {
            off_s[u] = k;
            if (!STORE)
                for (int l = 0; l < t.L; ++l)
                    if (__ldg(t.u_of_lane + l) == u) lane_s[k++] = l;
        }
        off_s[U] = k;
    }
    if (SHARED) lanes::init(smem, t.L, t.G, a0.J, a0.acc_op);
    __syncthreads();
    // whether any lane (the store: the one group) takes row s
    auto wanted = [&](int64_t s) {
        if (STORE) {
            const int g = __ldg(t.gids + s);
            return g >= 0 && g < t.G;
        }
        return lanes::wants(t, lane_s, off_s[U], s);
    };
    auto issue = [&](int tile, int b) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::issue_tile(a0.ts, a0.vals, a0.raw, narr, s0, min(R, a0.S - (int)s0), R, T,
                              stage + b * buf_words, [&](int r) {
                                  if (s0 + r >= a0.S || !wanted(s0 + r)) return 0;
                                  const int n = min(max(__ldg(a0.lens + s0 + r), 0), T);
                                  return (n + 3) >> 2;
                              });
    };
    row_tiles::for_each_tile<STAGED>(a0.S, R, issue, [&](int tile, int b) {
        const int64_t s0 = (int64_t)tile * R;
        const float* buf = stage + b * buf_words;
        const int rows = min(R, a0.S - (int)s0);
        for (int u = 0; u < U; ++u) {
            const int nl = off_s[u + 1] - off_s[u];
            if (!STORE && nl == 0) continue;
            RangeArgs a = a0;  // window u's grid
            a.start = __ldg(start + u);
            a.step = __ldg(step + u);
            a.window = __ldg(window + u);
            const int* lu = lane_s + off_s[u];
            float* pu = smem + 2 * (int64_t)off_s[u] * n_part;
            const group_acc::Store store{a.acc + (int64_t)u * a.ld * a.S, a.S};
            row_tiles::for_each_pair(rows, a.J, [&](int r, int j) {
                const int64_t s = s0 + r;
                if (s >= a.S) return;
                if (STORE) {
                    const int g = __ldg(t.gids + s);
                    if (g < 0 || g >= t.G) {
                        store.put(s, j, group_acc::nan_f());
                        return;
                    }
                } else if (!lanes::wants(t, lu, nl, s)) {
                    return;
                }
                const int n = min(max(__ldg(a.lens + s), 0), T);
                const int32_t* rt;
                const float* rv;
                const float* rr;
                if (STAGED) {
                    rt = (const int32_t*)(buf + (int64_t)r * T);
                    rv = buf + (int64_t)(R + r) * T;
                    rr = buf + (int64_t)(2 * R + r) * T;
                } else {
                    rt = a.ts + s * T;
                    rv = a.vals + s * T;
                    rr = a.raw + s * T;
                }
                const float v = window_value<KIND>(a, rt, rv, rr, n, j);
                if (STORE) store.put(s, j, v);
                else if (!isnan(v)) lanes::add<SHARED>(t, lu, nl, pu, a.J, s, j, v);
            });
        }
    });
    if (SHARED) {
        __syncthreads();
        lanes::flush(t, lane_s, off_s[U], smem, a0.J, 0);
    }
}

template <int KIND, bool STAGED, bool SHARED, bool STORE>
int launch_lanes(const RangeArgs& a, const lanes::Table& t, const int32_t* const* win, int U,
                 int smem, cudaStream_t stream) {
    auto kern = window_lanes_kernel<KIND, STAGED, SHARED, STORE>;
    int grid = 0;
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, (a.S + a.R - 1) / a.R, &grid);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, stream>>>(a, t, win[0], win[1], win[2], U);
    return (int)cudaGetLastError();
}

template <int KIND>
int lanes_kind(const RangeArgs& a, const lanes::Table& t, const int32_t* const* win, int U,
               bool store, bool shared, int smem, cudaStream_t st) {
    const bool staged = a.n_arrays > 0;
    if (store)
        return staged ? launch_lanes<KIND, true, false, true>(a, t, win, U, smem, st)
                      : launch_lanes<KIND, false, false, true>(a, t, win, U, smem, st);
    if (staged)
        return shared ? launch_lanes<KIND, true, true, false>(a, t, win, U, smem, st)
                      : launch_lanes<KIND, true, false, false>(a, t, win, U, smem, st);
    return shared ? launch_lanes<KIND, false, true, false>(a, t, win, U, smem, st)
                  : launch_lanes<KIND, false, false, false>(a, t, win, U, smem, st);
}

}  // namespace

// Plain C entry for ctypes: the lane mode of filodb_window_range_aggregate.
// ts, vals, raw, lens as the solo entry takes them; start, step and window
// [U] int32, one per unique window; gids [L, S] int32 and u_of_lane [L]
// int32 (L <= lanes::MAX_LANES); acc and cnt [L, G+1, ld] at the op's
// identity and zero. `rows`, `n_arrays`, `shared` and `smem_bytes` as the
// solo entry takes them, the partials sized for all L lanes (checked
// here). acc_op ACC_STORE: acc is the [U, ld, S] grids, gids [1, S] (rows
// outside [0, G) NaN), cnt and u_of_lane unread, `shared` 0. Steps [0, J)
// are computed. Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_window_range_lanes(
    const void* ts, const void* vals, const void* raw, const void* lens, const void* start,
    const void* step, const void* window, int S, int T, int J, int ld, int U, const void* gids,
    const void* u_of_lane, int L, int G, int func, int acc_op, int is_counter, int is_delta,
    int rows, int n_arrays, int shared, int smem_bytes, void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || U <= 0 || L <= 0) return 0;
    const int kind = kind_of(func, is_delta);
    const bool store = acc_op == group_acc::ACC_STORE;
    const int zero_cap = kind == K_EXTRAP && is_counter && func != W_DELTA;
    const int reads = kind == K_COUNT ? 1 : (zero_cap ? 3 : 2);  // ts, vals, raw
    const int64_t part = shared ? (((int64_t)2 * L * G * J + 3) & ~3) * 4 : 0;
    const int64_t need = part + (int64_t)2 * rows * T * 4 * n_arrays;
    if (kind < 0 || rows < 1 || T % 4 != 0 || n_arrays > 3 ||
        (n_arrays != 0 && n_arrays < reads) || smem_bytes < need || ld < J ||
        U > lanes::MAX_LANES || L > lanes::MAX_LANES || (store && (shared || L != 1)) ||
        !start || !step || !window || !gids || (!store && !u_of_lane))
        return (int)cudaErrorInvalidValue;
    RangeArgs a{(const int32_t*)ts, (const float*)vals, (const float*)raw,
                (const int32_t*)lens, nullptr, S, T, J, ld, G, 0, 0, 0, func, acc_op, zero_cap,
                rows, n_arrays, (float*)acc, (float*)cnt};
    const lanes::Table t{(const int32_t*)gids, (const int32_t*)u_of_lane, L, S, G,
                         (int64_t)(G + 1) * ld, ld, acc_op, (float*)acc, (float*)cnt};
    const int32_t* win[3] = {(const int32_t*)start, (const int32_t*)step, (const int32_t*)window};
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case K_COUNT: return lanes_kind<K_COUNT>(a, t, win, U, store, shared, smem_bytes, st);
        case K_SUM: return lanes_kind<K_SUM>(a, t, win, U, store, shared, smem_bytes, st);
        case K_MIN: return lanes_kind<K_MIN>(a, t, win, U, store, shared, smem_bytes, st);
        case K_MAX: return lanes_kind<K_MAX>(a, t, win, U, store, shared, smem_bytes, st);
        case K_FIRST: return lanes_kind<K_FIRST>(a, t, win, U, store, shared, smem_bytes, st);
        case K_LAST: return lanes_kind<K_LAST>(a, t, win, U, store, shared, smem_bytes, st);
        default: return lanes_kind<K_EXTRAP>(a, t, win, U, store, shared, smem_bytes, st);
    }
}

// Plain C entry for ctypes: op by (...) (func(m[w])) over a staged block.
// acc [G+1, ld] must hold the accumulator's identity (0, +inf or -inf) and
// cnt [G+1, ld] zeros; steps [0, J) are computed. `rows` rows per tile;
// `n_arrays` of ts, vals and raw (in that order) are staged per row in
// shared memory, 0 reads rows in place; `shared` keeps the group partials
// there; `smem_bytes` is the dynamic shared memory the wrapper sized for
// them (checked here, as is that the staged arrays hold what the function
// reads). acc_op ACC_STORE is the store mode: acc is the [ld, S] grid, cnt
// is not read, `shared` must be 0. Launches on `stream` and returns a
// cudaError_t (0 on success); it does not synchronise.
extern "C" int filodb_window_range_aggregate(
    const void* ts, const void* vals, const void* raw, const void* lens, const void* gids,
    int S, int T, int J, int ld, int G, int start, int step, int window, int func,
    int acc_op, int is_counter, int is_delta, int rows, int n_arrays, int shared,
    int smem_bytes, void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0) return 0;
    const int kind = kind_of(func, is_delta);
    const int zero_cap = kind == K_EXTRAP && is_counter && func != W_DELTA;
    RangeArgs a{(const int32_t*)ts, (const float*)vals, (const float*)raw,
                (const int32_t*)lens, (const long long*)gids, S, T, J, ld, G,
                (int32_t)start, (int32_t)step, (int32_t)window, func, acc_op, zero_cap, rows,
                n_arrays, (float*)acc, (float*)cnt};
    const int reads = kind == K_COUNT ? 1 : (zero_cap ? 3 : 2);  // ts, vals, raw
    const int64_t part = shared ? (((int64_t)2 * G * J + 3) & ~3) * 4 : 0;
    const int64_t need = part + (int64_t)2 * rows * T * 4 * n_arrays;
    if (kind < 0 || rows < 1 || T % 4 != 0 || n_arrays > 3 ||
        (n_arrays != 0 && n_arrays < reads) || smem_bytes < need ||
        (acc_op == group_acc::ACC_STORE && shared))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case K_COUNT: return launch_kind<K_COUNT>(a, shared, smem_bytes, st);
        case K_SUM: return launch_kind<K_SUM>(a, shared, smem_bytes, st);
        case K_MIN: return launch_kind<K_MIN>(a, shared, smem_bytes, st);
        case K_MAX: return launch_kind<K_MAX>(a, shared, smem_bytes, st);
        case K_FIRST: return launch_kind<K_FIRST>(a, shared, smem_bytes, st);
        case K_LAST: return launch_kind<K_LAST>(a, shared, smem_bytes, st);
        default: return launch_kind<K_EXTRAP>(a, shared, smem_bytes, st);
    }
}

// Plain C entry for ctypes. Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int filodb_window_stats(
    const void* ts, const void* vals, const void* raw, const void* lens,
    int S, int T, int J, int start, int step, int window,
    void* cnt, void* sum, void* mn, void* mx, void* tf, void* tl,
    void* vf, void* vl, void* rf, void* stream) {
    int64_t total = (int64_t)S * J;
    if (total <= 0) return 0;
    const int threads = 128;
    int64_t blocks = (total + threads - 1) / threads;
    window_stats_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ts, (const float*)vals, (const float*)raw, (const int32_t*)lens,
        S, T, J, (int32_t)start, (int32_t)step, (int32_t)window,
        (float*)cnt, (float*)sum, (float*)mn, (float*)mx, (float*)tf, (float*)tl,
        (float*)vf, (float*)vl, (float*)rf);
    return (int)cudaGetLastError();
}
