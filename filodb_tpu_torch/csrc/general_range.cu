// The general range functions fused with the group aggregate, on Hopper
// (sm_90a).
//
// general_range_kernel (entry filodb_general_range_aggregate) replaces the
// XLA program filodb_tpu/ops/kernels.py:141 range_kernel (B4) for the
// functions window statistics cannot express -- irate, idelta,
// stddev/stdvar_over_time, z_score, changes, resets, deriv, and for the
// reference tree predict_linear(t) and double_exponential_smoothing(sf, tf)
// (kernels.py:289 _holt_winters; their arguments arg0, arg1) -- with the
// ("agg", op) epilogue, as filodb_tpu/ops/aggregations.py
// _fused_general_jit composes them. One launch computes, for every (row s,
// step j < J), the function over the window (t_j - w, t_j] = samples
// [lo, hi) of the row, and reduces it into [G, J] group accumulators; no
// [S, J] plane reaches device memory.
//
// Design. A persistent grid of blocks of `warps` warps (the plan's; slice
// blockIdx.y owns steps [j0, j0 + steps), one slice unless J is very
// long). Each warp works alone on one row at a time -- rows s = its global
// warp index, + all warps, ... -- with no block barrier in its loop:
// 1. Its lanes copy the row's samples of ts, vals and, for changes/resets
//    that compare raw neighbours of a row of their own, raw, into the
//    warp's staging buffer with cp.async, and wait: the other warps of the
//    SM compute meanwhile (rows wider than the budget are read in place:
//    STAGED = false).
// 2. changes/resets on staged rows: the warp replaces the staged values
//    by the inclusive int32 prefix P of the row's pair flags (each lane a
//    contiguous chunk, then a warp scan), so a window holds P[hi-1] - P[lo]
//    flagged pairs lo < i < hi: the exact integer prefix difference of the
//    plain version, in O(1) per window.
// 3. Bounds: lane l takes steps l + 32 q (q < Q) and runs their 2 Q window
//    searches in lockstep (branchless, one length for all: each probe
//    level issues 2 Q independent loads), into the warp's [steps] lo/hi
//    table; on an exact shared grid (every real row holds row 0's samples)
//    the block searched one [steps] table at its start, and each row clamps
//    it by its length.
// 4. Values: lane l takes steps l, l + 32, ...: irate/idelta read the
//    samples at hi-1 and hi-2, changes/resets the prefix; the stddev family
//    (two passes: the window sum, then the squared deviations from its
//    mean), deriv and predict_linear (f64 sums of tc, v, tc^2, tc*v),
//    Holt-Winters (the level/trend recurrence, one sample after the
//    other) and changes/resets on rows
//    read in place walk the window four samples at a time into four
//    (deriv: two) partial sums. The lane owns its steps of the warp's
//    [steps] run, so values of rows in one group add up there without
//    atomics; when the warp's row changes group, and at its end, the run
//    folds into the block's shared [G, steps] partials (global atomics when
//    those exceed the wrapper's budget), flushed once per block.
//    Store mode (acc_op ACC_STORE, the variant STORE: the fused epilogues
//    topk/bottomk/quantile): the lane writes each of its steps' values,
//    NaN included, straight to the step-major [J_pad, S] grid `acc`
//    (group_acc.cuh Store; rows of the trash group as NaN) and keeps no
//    run: no flush, no shared partials, and no [steps] acc/cnt per warp.
// On an H100 at the main path's shape (tile_sweep.py --general) one lane
// per window beat teams of 2-32 lanes that stride a window and reduce it
// by __shfl_xor_sync (each window's fixed work and its shuffle chain are
// paid once per team; the sweep builds them as patched copies), and one
// staging buffer per warp beat a second one (which copied the next row
// during this one): more warps stay resident. 6 warps per block beat 2, 4
// and 8 or tied them, and the lockstep searches cut their share from about
// 0.1 ms to nothing measurable.
//
// Bound: device-memory bytes -- each real sample's ts and vals read once
// (raw too where changes/resets stage it), lens and gids, the [G, J]
// outputs: 553 MB on the main path (0.165 ms at 3.35 TB/s). The window
// work is a few float operations per in-window sample (deriv: four f64
// sums and two f32->f64 conversions, which run at a quarter of the f32
// rate), about 333 M in-window samples there: the card's rates cover it,
// but only with enough independent warps in flight to hide each lane's
// chain of shared-memory loads, which the design above is about.
//
// Semantics kept from range_kernel: time math in int32 with wrap-around
// (an empty window where the bounds wrap or w <= 0: lo = hi), single
// samples gathered at hi-1 and hi-2 (no tied runs summed), irate's
// dv / max(dt, 1e-30), changes/resets counting lo < i < hi (a cumulative
// counter's diff-staged value != 0 or < 0, else raw[i] against raw[i-1]),
// deriv's tc = (t - t_j) seconds rounded to f32 with the 1e-30 guard and
// NaN below two samples (predict_linear: the intercept plus the slope times
// arg0 seconds, from the same sums), Holt-Winters' first sample as the
// level, its second setting the trend to x1 - x0 and the level to x1, then
// level' = sf x + (1 - sf)(level + trend), trend' = tf (level' - level) +
// (1 - tf) trend, NaN below two samples. Two sums differ from range_kernel on purpose, as
// in the plain version: the stddev family's mean is the window's own sum,
// and deriv sums in f64. The build passes -fmad=false so that each f32
// multiply and add rounds separately, as in the plain PyTorch version.

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

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// range functions (ops/general_range.py GENERAL_FUNC_CODES)
enum GFunc {
    G_IRATE = 0, G_IDELTA, G_STDDEV_OVER_TIME, G_STDVAR_OVER_TIME, G_Z_SCORE, G_CHANGES,
    G_RESETS, G_DERIV, G_PREDICT_LINEAR, G_HOLT_WINTERS,
};
// what a function reads of its window: the kernel's template argument
enum Kind { K_LAST2 = 0, K_MOMENT2, K_PAIRS, K_LSQ, K_HW };

struct GenArgs {
    const int32_t* ts;
    const float* vals;
    const float* raw;
    const int32_t* lens;
    const long long* gids;
    int S, T, J, ld, G;
    int32_t start, step, window;
    int func, acc_op;
    float arg0, arg1;   // predict_linear's horizon (s); Holt-Winters' sf, tf
    int diff_flags;     // a cumulative counter: changes/resets/idelta read diff-staged vals
    int warps;          // warps per block, each on its own row
    int steps;          // steps per slice
    int n_arrays;       // arrays staged per row (ts, vals, raw in order); 0: read in place
    int shared_bounds;  // every real row holds row 0's samples
    float* acc;
    float* cnt;
};

constexpr int MAX_WARPS = 8;
// blocks of MAX_WARPS warps per SM the registers are cut for (64 a thread)
constexpr int MIN_BLOCKS = 4;
constexpr int Q = 4;  // steps whose window searches one lane runs in lockstep

__host__ __device__ __forceinline__ int64_t round4(int64_t x) { return (x + 3) & ~(int64_t)3; }

// [steps] arrays per warp: its row's lo/hi table, and its acc/cnt run
// unless it stores
__host__ __device__ __forceinline__ int warp_tables(bool store) { return store ? 2 : 4; }

// Words of dynamic shared memory (ops/general_range.general_smem_bytes
// mirrors it): the block's [G, steps] acc/cnt partials (shared), its
// [steps] lo/hi table (shared bounds), and per warp its row's [steps]
// lo/hi table, its [steps] acc/cnt run (not in store mode) and its
// staging buffer.
__host__ __device__ __forceinline__ int64_t smem_words(int G, int steps, int warps, int T,
                                                       int n_arrays, bool shared,
                                                       bool shared_bounds, bool store) {
    const int64_t part = shared ? round4((int64_t)2 * G * steps) : 0;
    const int64_t sb = shared_bounds ? 2 * round4(steps) : 0;
    return part + sb +
           (int64_t)warps * (warp_tables(store) * round4(steps) + (int64_t)n_arrays * T);
}

// the pair flag of sample k >= 1: a diff-staged value != 0 (changes) or
// < 0 (resets), else raw[k] against raw[k-1]
__device__ __forceinline__ int pair_flag(bool changes, bool diff, const float* rv,
                                         const float* rr, int k) {
    if (diff) {
        const float d = rv[k];
        return changes ? d != 0.0f : d < 0.0f;
    }
    const float c = rr[k], p = rr[k - 1];
    return changes ? c != p : c < p;
}

// Replace a staged row's n values by the inclusive prefix of its pair
// flags, as int32 (P[0] = 0), by one warp: each lane counts the flags of a
// contiguous chunk of the row (an odd stride of words, so the lanes' reads
// fall in distinct banks), a warp scan turns the counts into chunk offsets,
// and each lane writes its chunk's prefix. A lane reads each raw value
// before it writes that word, and keeps its chunk's raw predecessor from
// the first pass, so a raw row that is the values row itself works too.
__device__ __forceinline__ void flag_prefix(const GenArgs& a, float* rv, const float* rr,
                                            int n) {
    const int lane = threadIdx.x & 31;
    const bool changes = a.func == G_CHANGES;
    const int chunk = ((n + 31) / 32) | 1;
    const int k0 = min(lane * chunk, n), k1 = min(k0 + chunk, n);
    auto flag = [&](int k, float c, float p) -> int {  // flag k >= 1 of value c after p
        if (k == 0) return 0;
        return a.diff_flags ? (changes ? c != 0.0f : c < 0.0f) : (changes ? c != p : c < p);
    };
    const float* src = a.diff_flags ? rv : rr;
    const float before = k0 > 0 && k0 < k1 ? src[k0 - 1] : 0.0f;
    int count = 0;
    float p = before;
    for (int k = k0; k < k1; ++k) {
        const float c = src[k];
        count += flag(k, c, p);
        p = c;
    }
    int x = count;  // inclusive warp scan of the chunk counts
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    __syncwarp();  // every lane has read its predecessor before any write
    int run = x - count;
    p = before;
    for (int k = k0; k < k1; ++k) {
        const float c = src[k];
        run += flag(k, c, p);
        p = c;
        reinterpret_cast<int*>(rv)[k] = run;
    }
}

// The value of a kind that reads O(1) samples of the window [lo, hi)
template <int KIND>
__device__ __forceinline__ float pair_value(const int32_t* rt, const float* rv, int lo, int hi,
                                            const GenArgs& a) {
    const float NaN = group_acc::nan_f();
    if (hi <= lo) return NaN;
    if (KIND == K_PAIRS)  // the staged prefix: flagged i with lo < i < hi
        return (float)(reinterpret_cast<const int*>(rv)[hi - 1] -
                       reinterpret_cast<const int*>(rv)[lo]);
    // irate, idelta: the samples at hi-1 and hi-2
    if (hi - lo < 2) return NaN;
    const float v_last = rv[hi - 1];
    if (a.func == G_IDELTA && a.diff_flags) return v_last;  // the staged diff
    const float dv = v_last - rv[hi - 2];
    if (a.func == G_IDELTA) return dv;
    const float dt_s = (float)wrap_sub(rt[hi - 1], rt[hi - 2]) * 1e-3f;
    return dv / fmaxf(dt_s, 1e-30f);
}

// Walk the window [lo, hi): f(k, slot) four samples at a time into four
// partial sums (slot 0-3), so that four loads are in flight.
template <typename F>
__device__ __forceinline__ void for_window(int lo, int hi, F f) {
    int k = lo;
    for (; k + 3 < hi; k += 4) {
        f(k, 0);
        f(k + 1, 1);
        f(k + 2, 2);
        f(k + 3, 3);
    }
    for (; k < hi; ++k) f(k, 0);
}

// the total of a walk's partial sums
template <typename X>
__device__ __forceinline__ X total(const X (&x)[4]) {
    return (x[0] + x[1]) + (x[2] + x[3]);
}
template <typename X>
__device__ __forceinline__ X total(const X (&x)[2]) {
    return x[0] + x[1];
}

// The value of a non-empty window [lo, hi) of a kind that walks it
template <int KIND>
__device__ __forceinline__ float window_value(const GenArgs& a, const int32_t* rt,
                                              const float* rv, const float* rr, int lo, int hi,
                                              int32_t t_j) {
    if (KIND == K_MOMENT2) {  // stddev/stdvar_over_time, z_score: two passes
        const float cnt = (float)(hi - lo);
        float sm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for_window(lo, hi, [&](int k, int i) { sm[i] += rv[k]; });
        const float mean = total(sm) / fmaxf(cnt, 1.0f);
        float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for_window(lo, hi, [&](int k, int i) {
            const float d = rv[k] - mean;
            ss[i] += d * d;
        });
        const float var = total(ss) / fmaxf(cnt, 1.0f);
        if (a.func == G_STDVAR_OVER_TIME) return var;
        const float sd = sqrtf(var);
        if (a.func == G_Z_SCORE) return (rv[hi - 1] - mean) / fmaxf(sd, 1e-30f);
        return sd;
    }
    if (KIND == K_PAIRS) {  // rows read in place: count the flags of lo < i < hi
        const bool changes = a.func == G_CHANGES;
        int flagged[4] = {0, 0, 0, 0};
        for_window(lo + 1, hi, [&](int k, int i) {
            flagged[i] += pair_flag(changes, a.diff_flags, rv, rr, k);
        });
        return (float)total(flagged);
    }
    if (KIND == K_HW) {  // Holt-Winters: the level after the window's samples in order
        if (hi - lo < 2) return group_acc::nan_f();
        const float sf = a.arg0, tf = a.arg1;
        float trend = rv[lo + 1] - rv[lo];
        float level = rv[lo + 1];
        for (int k = lo + 2; k < hi; ++k) {
            const float x = rv[k];
            const float next = sf * x + (1.0f - sf) * (level + trend);
            trend = tf * (next - level) + (1.0f - tf) * trend;
            level = next;
        }
        return level;
    }
    // deriv (and predict_linear): least-squares slope over (t - t_j) seconds; tc rounds to f32
    // as in range_kernel, the sums run in f64 (tc * tc and tc * v of two
    // f32 values are exact there, so fma rounds as a multiply and an add).
    // An in-window t - t_j lies in (-w, 0]: below 2^22 it converts to f32
    // exactly by the magic-number add (the integer conversion runs at a
    // quarter of the f32 rate on this card).
    const bool magic = a.window > 0 && a.window < (1 << 22);
    double st[2] = {0, 0}, sv[2] = {0, 0}, stt[2] = {0, 0}, stv[2] = {0, 0};
    for_window(lo, hi, [&](int k, int slot) {
        const int i = slot & 1;  // two partial sums of each (registers)
        const int32_t d = wrap_sub(rt[k], t_j);
        const float df = magic ? __int_as_float(0x4B400000 + d) - 12582912.0f : (float)d;
        const double tc = (double)(df * 1e-3f);
        const double v = (double)rv[k];
        st[i] += tc;
        sv[i] += v;
        stt[i] = fma(tc, tc, stt[i]);
        stv[i] = fma(tc, v, stv[i]);
    });
    const double s_t = total(st), s_v = total(sv), s_tt = total(stt), s_tv = total(stv);
    const double n = (double)(hi - lo);
    const double denom = n * s_tt - s_t * s_t;
    if (hi - lo < 2 || !(fabs(denom) >= 1e-30)) return group_acc::nan_f();
    const double slope = (n * s_tv - s_t * s_v) / denom;
    if (a.func == G_DERIV) return (float)slope;
    const double intercept = (s_v - slope * s_t) / fmax(n, 1.0);  // predict_linear at +arg0 s
    return (float)(intercept + slope * (double)a.arg0);
}

__device__ __forceinline__ float combine(int acc_op, float x, float v) {
    return acc_op == group_acc::ACC_MIN ? fminf(x, v)
                                        : (acc_op == group_acc::ACC_MAX ? fmaxf(x, v) : x + v);
}

// The windows [lo[q], hi[q]) of the steps t_j[q] in a sorted row of n
// samples: hi = the samples <= t_j, lo = those <= t_j - w, at most hi (an
// empty window where the bounds wrap or w <= 0), as window_search.cuh's
// count_le / lower_edge count them. Branchless searches of one length for
// all 2 Q targets, so each probe level issues 2 Q independent loads. LDG: a
// row in device memory.
template <bool LDG>
__device__ __forceinline__ void search_bounds(const int32_t* row, int n, const int32_t (&t_j)[Q],
                                              int32_t window, int (&lo)[Q], int (&hi)[Q]) {
    int32_t t_lo[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        t_lo[q] = wrap_add(t_j[q], -window);
        lo[q] = hi[q] = 0;
    }
    auto at = [&](int i) { return LDG ? __ldg(row + i) : row[i]; };
    int len = n;
    for (; len > 1; len -= len >> 1) {
        const int half = len >> 1;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            hi[q] += at(hi[q] + half) <= t_j[q] ? half : 0;
            lo[q] += at(lo[q] + half) <= t_lo[q] ? half : 0;
        }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        if (len == 1) {
            hi[q] += at(hi[q]) <= t_j[q];
            lo[q] += at(lo[q]) <= t_lo[q];
        }
        lo[q] = min(lo[q], hi[q]);
    }
}

// wait until none of this thread's cp.async groups is in flight
__device__ __forceinline__ void wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int KIND, bool STAGED, bool SHARED, bool STORE>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
    general_range_kernel(const GenArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int T = a.T, W = a.steps;
    const int j0 = blockIdx.y * W;
    const int ns = min(W, a.J - j0);  // this slice's steps
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t part = SHARED ? round4((int64_t)2 * a.G * W) : 0;
    float* acc_s = smem;
    float* cnt_s = smem + (int64_t)a.G * W;
    const int64_t nsb = a.shared_bounds ? round4(W) : 0;
    int* sb_lo = reinterpret_cast<int*>(smem + part);
    int* sb_hi = sb_lo + nsb;
    float* tables = reinterpret_cast<float*>(sb_hi + nsb);
    const int64_t per_warp = (int64_t)warp_tables(STORE) * round4(W);
    int* tb_lo = reinterpret_cast<int*>(tables + warp * per_warp);  // this warp's row bounds
    int* tb_hi = tb_lo + round4(W);
    float* run_acc = reinterpret_cast<float*>(tb_hi + round4(W));  // its [steps] run
    float* run_cnt = run_acc + round4(W);
    const int narr = a.n_arrays;
    const int64_t buf_words = (int64_t)narr * T;
    float* stage = tables + a.warps * per_warp + (int64_t)warp * buf_words;
    const group_acc::Store store{a.acc, a.S};
    const float ident = group_acc::identity(a.acc_op);
    auto t_of = [&](int j) { return wrap_add(a.start, wrap_mul(j, a.step)); };
    auto gid_of = [&](int64_t s) {  // -1 for the trash group G (padding) or no group
        const long long g = __ldg(a.gids + s);
        return (g < 0 || g >= a.G) ? -1 : (int)g;
    };
    auto len_of = [&](int64_t s) { return min(max(__ldg(a.lens + s), 0), T); };

    if (SHARED) group_acc::shared_init(acc_s, cnt_s, a.G * W, a.acc_op);
    if (a.shared_bounds) {  // the same window in every real row: row 0's
        const int32_t* rt0 = a.ts;
        const int n0 = len_of(0);
        for (int jl = threadIdx.x; jl < ns; jl += blockDim.x) {
            const int32_t t_j = t_of(j0 + jl);
            const int hi = count_le<true>(rt0, n0, t_j);
            sb_hi[jl] = hi;
            sb_lo[jl] = lower_edge(rt0, hi, wrap_add(t_j, -a.window));
        }
    }
    if (!STORE)
        for (int jl = lane; jl < W; jl += 32) {
            run_acc[jl] = ident;
            run_cnt[jl] = 0.0f;
        }
    __syncthreads();  // the block's partials and bounds table are set

    // fold the warp's run into group g (the block's partials, or global)
    auto flush = [&](int g) {
        __syncwarp();
        for (int jl = lane; jl < ns; jl += 32) {
            const float n = run_cnt[jl];
            if (n > 0.0f) {
                const int64_t o = SHARED ? (int64_t)g * W + jl : (int64_t)g * a.ld + j0 + jl;
                group_acc::fold(SHARED ? acc_s + o : a.acc + o, SHARED ? cnt_s + o : a.cnt + o,
                                a.acc_op, run_acc[jl], n);
                run_acc[jl] = ident;
                run_cnt[jl] = 0.0f;
            }
        }
        __syncwarp();
    };
    // the row's samples of ts, vals (and raw) into the warp's buffer
    auto stage_row = [&](int64_t s) {
        const int chunks = (len_of(s) + 3) >> 2;
        float* d = stage;
        for (int c = lane; c < chunks; c += 32) {
            const int64_t off = s * T + 4 * c;
            row_tiles::cp_async16(d + 4 * c, a.ts + off);
            row_tiles::cp_async16(d + T + 4 * c, a.vals + off);
            if (narr > 2) row_tiles::cp_async16(d + 2 * T + 4 * c, a.raw + off);
        }
    };

    const int64_t stride = (int64_t)gridDim.x * a.warps;
    int64_t s = (int64_t)blockIdx.x * a.warps + warp;
    int g_run = -1;
    for (; s < a.S; s += stride) {
        const int g = gid_of(s);
        if (g >= 0) {
            if (STAGED) {  // other warps compute while this one waits for its row
                stage_row(s);
                row_tiles::commit();
                wait_all();
                __syncwarp();
            }
            if (!STORE && g != g_run) {
                if (g_run >= 0) flush(g_run);
                g_run = g;
            }
            const int n = len_of(s);
            const int32_t* rt = STAGED ? reinterpret_cast<const int32_t*>(stage) : a.ts + s * T;
            float* rv = STAGED ? stage + T : nullptr;
            const float* rvc = STAGED ? rv : a.vals + s * T;
            const float* rr = STAGED ? (narr > 2 ? stage + 2 * T : rv) : a.raw + s * T;
            if (KIND == K_PAIRS && STAGED) {
                flag_prefix(a, rv, rr, n);
                __syncwarp();
            }
            // the row's windows: lane takes steps jq + 32 q (q < Q), its
            // 2 Q searches in lockstep, into the warp's bounds table
            for (int jq = lane; jq < ns; jq += Q * 32) {
                int lo[Q], hi[Q];
                int32_t t_j[Q];
#pragma unroll
                for (int q = 0; q < Q; ++q) t_j[q] = t_of(j0 + jq + 32 * q);
                if (a.shared_bounds) {
#pragma unroll
                    for (int q = 0; q < Q; ++q) {
                        const int jl = min(jq + 32 * q, ns - 1);
                        hi[q] = min(sb_hi[jl], n);
                        lo[q] = min(sb_lo[jl], hi[q]);
                    }
                } else {
                    search_bounds<!STAGED>(rt, n, t_j, a.window, lo, hi);
                }
#pragma unroll
                for (int q = 0; q < Q; ++q)
                    if (jq + 32 * q < ns) {
                        tb_lo[jq + 32 * q] = lo[q];
                        tb_hi[jq + 32 * q] = hi[q];
                    }
            }
            __syncwarp();
            // the lane's steps jl, jl + 32, ... (it owns them in the warp's run)
            for (int jl = lane; jl < ns; jl += 32) {
                const int lo = tb_lo[jl], hi = tb_hi[jl];
                float v = group_acc::nan_f();
                if constexpr (KIND == K_LAST2 || (KIND == K_PAIRS && STAGED))
                    v = pair_value<KIND>(rt, rvc, lo, hi, a);
                else if (hi > lo)
                    v = window_value<KIND>(a, rt, rvc, rr, lo, hi, t_of(j0 + jl));
                if (STORE) {
                    store.put(s, j0 + jl, v);
                    continue;
                }
                if (!isnan(v)) {
                    run_acc[jl] = combine(a.acc_op, run_acc[jl], v);
                    run_cnt[jl] += 1.0f;
                }
            }
        } else if (STORE) {  // a row of the trash group
            for (int jl = lane; jl < ns; jl += 32) store.put(s, j0 + jl, group_acc::nan_f());
        }
        __syncwarp();  // before the next row refills the buffer and the bounds table
    }
    if (!STORE && g_run >= 0) flush(g_run);
    if (SHARED) {  // the block's [G, steps] partials are columns j0 .. of the global arrays
        __syncthreads();
        group_acc::shared_flush(acc_s, cnt_s, a.G, W, a.acc + j0, a.cnt + j0, a.ld, a.acc_op);
    }
}

template <int KIND, bool STAGED, bool SHARED, bool STORE = false>
int launch(const GenArgs& a, int smem, int slices, cudaStream_t stream) {
    auto kern = general_range_kernel<KIND, STAGED, SHARED, STORE>;
    const int threads = 32 * a.warps;
    int resident = 0;  // also raises the kernel's shared-memory allowance to smem
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, 1 << 30, &resident, threads);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (a.S + a.warps - 1) / a.warps;
    const int grid = max(1, min(blocks, resident / slices));
    kern<<<dim3(grid, slices), threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const GenArgs& a, int shared, int smem, int slices, cudaStream_t st) {
    if (a.acc_op == group_acc::ACC_STORE)
        return a.n_arrays > 0 ? launch<KIND, true, false, true>(a, smem, slices, st)
                              : launch<KIND, false, false, true>(a, smem, slices, st);
    if (a.n_arrays > 0)
        return shared ? launch<KIND, true, true>(a, smem, slices, st)
                      : launch<KIND, true, false>(a, smem, slices, st);
    return shared ? launch<KIND, false, true>(a, smem, slices, st)
                  : launch<KIND, false, false>(a, smem, slices, st);
}

int kind_of(int func) {
    switch (func) {
        case G_IRATE: case G_IDELTA: return K_LAST2;
        case G_STDDEV_OVER_TIME: case G_STDVAR_OVER_TIME: case G_Z_SCORE: return K_MOMENT2;
        case G_CHANGES: case G_RESETS: return K_PAIRS;
        case G_DERIV: case G_PREDICT_LINEAR: return K_LSQ;
        case G_HOLT_WINTERS: return K_HW;
        default: return -1;
    }
}

}  // namespace

// Plain C entry for ctypes: op by (...) (func(m[w])) over a staged block
// for the general functions. acc [G+1, ld] must hold the accumulator's
// identity (0, +inf or -inf) and cnt [G+1, ld] zeros; steps [0, J) are
// computed. The layout comes from the wrapper's plan
// (ops/general_range.general_plan): `warps` warps per block, each with a
// staging buffer of `n_arrays` of ts, vals and raw (in that order) per row
// in shared memory (0 arrays: rows read in place), `steps`
// steps per slice (ceil(J / steps) slices), `shared` [G, steps] partials
// in shared memory, `shared_bounds` (every real row holds the samples of
// row 0) and `smem_bytes` of dynamic shared memory, checked here, as is that the
// staged arrays hold what the function reads. acc_op ACC_STORE is the
// store mode: acc is the [ld, S] grid, cnt is not read, `shared` must be
// 0. arg0 and arg1 are the function's arguments (predict_linear's horizon
// in seconds; Holt-Winters' smoothing and trend factors), unread by the
// other functions. Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_general_range_aggregate(
    const void* ts, const void* vals, const void* raw, const void* lens, const void* gids,
    int S, int T, int J, int ld, int G, int start, int step, int window, int func,
    int acc_op, float arg0, float arg1, int is_counter, int is_delta, int warps, int steps,
    int n_arrays,
    int shared, int shared_bounds, int smem_bytes, void* acc,
    void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0) return 0;
    const int kind = kind_of(func);
    const int diff_flags = is_counter && !is_delta;
    // changes/resets of a gauge or delta counter compare raw neighbours
    const int reads = kind == K_PAIRS && !diff_flags && raw != vals ? 3 : 2;  // ts, vals, raw
    const int slices = steps > 0 ? (J + steps - 1) / steps : 0;
    const bool store = acc_op == group_acc::ACC_STORE;
    if (kind < 0 || warps < 1 || warps > MAX_WARPS || steps < 1 ||
        slices > 65535 || ld < J || (store && shared) ||
        (n_arrays != 0 && (n_arrays < reads || n_arrays > 3 || T % 4 != 0)) ||
        (int64_t)smem_bytes !=
            4 * smem_words(G, steps, warps, T, n_arrays, shared, shared_bounds, store))
        return (int)cudaErrorInvalidValue;
    GenArgs a{(const int32_t*)ts, (const float*)vals, (const float*)raw, (const int32_t*)lens,
              (const long long*)gids, S, T, J, ld, G, (int32_t)start, (int32_t)step,
              (int32_t)window, func, acc_op, arg0, arg1, diff_flags, warps, steps, n_arrays,
              shared_bounds, (float*)acc, (float*)cnt};
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case K_LAST2: return launch_kind<K_LAST2>(a, shared, smem_bytes, slices, st);
        case K_MOMENT2: return launch_kind<K_MOMENT2>(a, shared, smem_bytes, slices, st);
        case K_PAIRS: return launch_kind<K_PAIRS>(a, shared, smem_bytes, slices, st);
        case K_HW: return launch_kind<K_HW>(a, shared, smem_bytes, slices, st);
        default: return launch_kind<K_LSQ>(a, shared, smem_bytes, slices, st);
    }
}

// Lane mode (B12: _batched_general_jit, filodb_tpu/ops/aggregations.py:1208,
// which runs range_kernel once per unique window and _apply_epilogue once
// per lane). One launch over U unique windows (blockIdx.y = u; start, step
// and window [U] int32): a block walks tiles of rows, its threads take the
// tile's (row, step) pairs flattened (row_tiles.cuh), each searches its
// window [lo, hi) in the row in place (window_search.cuh) and computes the
// value once (pair_value / window_value, the solo kernel's functions), then
// folds it into every lane of u at the lane's group (group_acc.cuh
// lanes::). STORE: the [U, ld, S] store grids, rows outside the group of
// gids[0] NaN. A simple layout, not the solo kernel's warp per row: no
// staging, no shared bounds table, a search per (row, step). Bound: each
// real sample's ts and vals read once per window (U times), L * S * 4
// bytes of gids and the [L, G, J] outputs.
namespace {

template <int KIND, bool SHARED, bool STORE>
__global__ void __launch_bounds__(row_tiles::THREADS) general_lanes_kernel(
    const GenArgs a0, const lanes::Table t, const int32_t* start, const int32_t* step,
    const int32_t* window, int R) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int lane_s[lanes::MAX_LANES];
    __shared__ int nl_s;
    const int u = blockIdx.y;
    GenArgs a = a0;  // window u's grid
    a.start = __ldg(start + u);
    a.step = __ldg(step + u);
    a.window = __ldg(window + u);
    if (STORE) {
        if (threadIdx.x == 0) nl_s = 0;
    } else {
        lanes::collect(t, u, lane_s, &nl_s);
    }
    __syncthreads();
    const int nl = nl_s;
    if (SHARED) {
        lanes::init(smem, nl, t.G, a.J, a.acc_op);
        __syncthreads();
    }
    const group_acc::Store store{a.acc + (int64_t)u * a.ld * a.S, a.S};
    auto value = [&](int64_t s, int j) {
        const int n = min(max(__ldg(a.lens + s), 0), a.T);
        const int32_t* rt = a.ts + s * a.T;
        const float* rv = a.vals + s * a.T;
        const float* rr = a.raw + s * a.T;
        const int32_t t_j = wrap_add(a.start, wrap_mul(j, a.step));
        const int hi = count_le<true>(rt, n, t_j);
        const int lo = min(lower_edge(rt, hi, wrap_add(t_j, -a.window)), hi);
        if constexpr (KIND == K_LAST2) {
            return pair_value<KIND>(rt, rv, lo, hi, a);
        } else {
            return hi > lo ? window_value<KIND>(a, rt, rv, rr, lo, hi, t_j) : group_acc::nan_f();
        }
    };
    row_tiles::for_each_tile<false>(a.S, R, [](int, int) {}, [&](int tile, int) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::for_each_pair(min(R, a.S - (int)s0), a.J, [&](int r, int j) {
            const int64_t s = s0 + r;
            if (s >= a.S) return;
            if (STORE) {
                const int g = __ldg(t.gids + s);
                store.put(s, j, g < 0 || g >= t.G ? group_acc::nan_f() : value(s, j));
                return;
            }
            if (!lanes::wants(t, lane_s, nl, s)) return;
            const float v = value(s, j);
            if (!isnan(v)) lanes::add<SHARED>(t, lane_s, nl, smem, a.J, s, j, v);
        });
    });
    if (SHARED) {
        __syncthreads();
        lanes::flush(t, lane_s, nl, smem, a.J, 0);
    }
}

template <int KIND, bool SHARED, bool STORE>
int launch_lanes(const GenArgs& a, const lanes::Table& t, const int32_t* const* win, int U,
                 int R, int smem, cudaStream_t stream) {
    auto kern = general_lanes_kernel<KIND, SHARED, STORE>;
    int resident = 0;  // also raises the kernel's shared-memory allowance to smem
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, 1 << 30, &resident);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (a.S + R - 1) / R;
    const int grid = max(1, min(tiles, resident / U));
    kern<<<dim3(grid, U), row_tiles::THREADS, smem, stream>>>(a, t, win[0], win[1], win[2], R);
    return (int)cudaGetLastError();
}

template <int KIND>
int lanes_kind(const GenArgs& a, const lanes::Table& t, const int32_t* const* win, int U, int R,
               bool store, bool shared, int smem, cudaStream_t st) {
    if (store) return launch_lanes<KIND, false, true>(a, t, win, U, R, smem, st);
    return shared ? launch_lanes<KIND, true, false>(a, t, win, U, R, smem, st)
                  : launch_lanes<KIND, false, false>(a, t, win, U, R, smem, st);
}

}  // namespace

// Plain C entry for ctypes: the lane mode of filodb_general_range_aggregate.
// ts, vals, raw, lens as the solo entry takes them; start, step and window
// [U] int32, one per unique window; gids [L, S] int32 and u_of_lane [L]
// int32 (L <= lanes::MAX_LANES); acc and cnt [L, G+1, ld] at the op's
// identity and zero; `rows` rows per tile. `shared` keeps every lane's
// partials in shared memory, sized by the wrapper for `lanes_max` lanes of
// one window (`smem_bytes`, checked here). acc_op ACC_STORE: acc is the
// [U, ld, S] grids, gids [1, S] (rows outside [0, G) NaN), cnt and
// u_of_lane unread, `shared` 0. Steps [0, J) are computed. Launches on
// `stream` and returns a cudaError_t (0 on success); it does not
// synchronise.
extern "C" int filodb_general_range_lanes(
    const void* ts, const void* vals, const void* raw, const void* lens, const void* start,
    const void* step, const void* window, int S, int T, int J, int ld, int U, const void* gids,
    const void* u_of_lane, int L, int G, int func, int acc_op, float arg0, float arg1,
    int is_counter, int is_delta, int rows, int shared, int lanes_max, int smem_bytes,
    void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || U <= 0 || L <= 0) return 0;
    const int kind = kind_of(func);
    const bool store = acc_op == group_acc::ACC_STORE;
    const int64_t part = shared ? (((int64_t)2 * lanes_max * G * J + 3) & ~3) * 4 : 0;
    if (kind < 0 || rows < 1 || ld < J || U > 65535 || L > lanes::MAX_LANES || lanes_max < 1 ||
        lanes_max > L || smem_bytes < part || (store && shared) || !start || !step ||
        !window || !gids || (!store && !u_of_lane))
        return (int)cudaErrorInvalidValue;
    GenArgs a{(const int32_t*)ts, (const float*)vals, (const float*)raw, (const int32_t*)lens,
              nullptr, S, T, J, ld, G, 0, 0, 0, func, acc_op, arg0, arg1,
              is_counter && !is_delta, 1, J, 0, 0, (float*)acc, (float*)cnt};
    const lanes::Table t{(const int32_t*)gids, (const int32_t*)u_of_lane, L, S, G,
                         (int64_t)(G + 1) * ld, ld, acc_op, (float*)acc, (float*)cnt};
    const int32_t* win[3] = {(const int32_t*)start, (const int32_t*)step, (const int32_t*)window};
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case K_LAST2: return lanes_kind<K_LAST2>(a, t, win, U, rows, store, shared, smem_bytes, st);
        case K_MOMENT2:
            return lanes_kind<K_MOMENT2>(a, t, win, U, rows, store, shared, smem_bytes, st);
        case K_PAIRS: return lanes_kind<K_PAIRS>(a, t, win, U, rows, store, shared, smem_bytes, st);
        case K_HW: return lanes_kind<K_HW>(a, t, win, U, rows, store, shared, smem_bytes, st);
        default: return lanes_kind<K_LSQ>(a, t, win, U, rows, store, shared, smem_bytes, st);
    }
}
