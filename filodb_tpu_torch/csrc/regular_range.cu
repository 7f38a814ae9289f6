// Regular-grid range function fused with the group aggregate, on Hopper
// (sm_90a).
//
// Also the rest of the JAX package's MXU rung (the reference tree's leaves
// on a regular grid): B5 mxu_pair_count (filodb_tpu/ops/mxu_kernels.py:364,
// changes/resets), mxu_minmax (:371), mxu_regression (:400, deriv and
// predict_linear) and mxu_range_kernel's absent_over_time arm (:304).
// Replaces two XLA programs of the JAX package that
// filodb_tpu/ops/aggregations.py:_fused_mxu_jit runs as one: B2
// mxu_range_kernel (filodb_tpu/ops/mxu_kernels.py:250) and B3
// _segment_aggregate_jit (filodb_tpu/ops/aggregations.py:49). Every real row
// of the block shares one timestamp vector, so the window of step j is the
// same index range [lo[j], hi[j]) in every row. For each (row s, step j <
// J) the kernel computes the range function and reduces it straight into
// group accumulators acc (sum, min or max) and cnt (valid members); no
// [S, J] grid is written. Steps past J (the padding up to the row stride
// ld) are not computed. The [G, J] finish (has = cnt > 0, the avg
// division, NaN for empty groups) is a few torch ops in the wrapper.
//
// Store mode (acc_op ACC_STORE, the compile-time variant STORE: the fused
// epilogues topk/bottomk/quantile): each (row, step < J) value is written
// once, NaN included, to the step-major [J_pad, S] grid `acc` instead
// (group_acc.cuh Store; rows of the trash group as NaN); no partials.
//
// Design. The TPU gathers with one-hot matmuls (vals @ F, vals @ L) and
// sums windows with vals @ W. Here a load at lo[j], hi[j]-1 or hi[j]-2 is
// the gather and a loop over [lo[j], hi[j]) the window sum, taken in index
// order. A persistent grid of 256-thread blocks walks tiles of R rows
// (row_tiles.cuh). The block's threads take the tile's (row, step) pairs
// flattened row by row, so every lane has a pair whatever J is (only the
// tile's last wave is partial), and neighbouring lanes read neighbouring
// windows of one row. Rows are read in place from device memory: a warp's
// windows cover a few consecutive sectors of one row, which coalesce and
// are reused through L1; the same kernel staging row tiles in shared
// memory with cp.async measured slower on an H100 (PERF.md, layout
// sweep). Values reduce through group_acc.cuh: shared-memory partials
// flushed once per block while 2*G*J*4 bytes fit the wrapper's budget,
// else global atomics.
//
// Bound. Device-memory bytes: the sectors of vals (and of raw, for the
// counter zero-crossing cap and changes/resets) that the function reads,
// gids, and the outputs; a few dozen flops per (row, step), plus a pass
// over the window for the B5 functions.
//
// Semantics kept line by line from mxu_range_kernel: f32 Prometheus
// extrapolation of rate/increase/delta with the zero-crossing cap read from
// raw[lo]; irate/idelta from hi-1 and hi-2 (idelta on diff-staged counters
// is vals[hi-1]); stddev/stdvar/z_score by s2/c - mean^2; count and
// present give values on every row. A NaN result means absence and is
// skipped by the aggregate. The build passes -fmad=false so that each f32
// multiply and add rounds separately, as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"
#include "row_tiles.cuh"

namespace {

using group_acc::nan_min;
using row_tiles::THREADS;

// range functions (ops/mxu_kernels.py FUNC_CODES)
enum Func {
    SUM_OVER_TIME = 0, COUNT_OVER_TIME, AVG_OVER_TIME, LAST, FIRST_OVER_TIME,
    PRESENT_OVER_TIME, STDDEV_OVER_TIME, STDVAR_OVER_TIME, Z_SCORE, RATE,
    INCREASE, DELTA, IRATE, IDELTA, CHANGES, RESETS, MIN_OVER_TIME, MAX_OVER_TIME,
    DERIV, PREDICT_LINEAR, ABSENT_OVER_TIME,
};

constexpr float MINMAX_SENTINEL = 3e38f;  // mxu_minmax's sentinel

struct RegularArgs {
    const float* vals;
    const float* raw;
    const long long* gids;
    const int32_t* lo;
    const int32_t* hi;
    const int32_t* idx;  // [3, ld]: first / last / second-to-last positions
    const float* count;
    const float* tf;
    const float* tl;
    const float* tl2;
    const float* out_t;
    const int32_t* rts;      // deriv/predict_linear: the shared ts [T]
    const double* out_t64;   // their step times [ld], f64
    const float* st;         // sum of Wt over each window [ld]
    const float* stt;        // sum of W * tc^2 over each window [ld]
    int S, T, J, ld, G;
    float window_ms;
    float lead;  // predict_linear's horizon (s)
    int func, acc_op, is_counter, is_delta;
    int R;  // rows per tile
    float* acc;
    float* cnt;
};

// functions whose value is a window sum of vals (mxu: vals @ W)
__device__ __forceinline__ bool is_win_sum(const RegularArgs& a) {
    return a.func == SUM_OVER_TIME || a.func == AVG_OVER_TIME ||
           (a.is_delta && (a.func == RATE || a.func == INCREASE));
}
__device__ __forceinline__ bool is_extrap(const RegularArgs& a) {
    return !is_win_sum(a) && (a.func == RATE || a.func == INCREASE || a.func == DELTA);
}
// the counter zero-crossing cap reads raw at the window's first sample
__device__ __forceinline__ bool needs_raw(const RegularArgs& a) {
    return is_extrap(a) && a.is_counter && a.func != DELTA;
}

// The range function of one row at step j; `row` and `rraw` are the row's
// vals and raw in device memory.
__device__ __forceinline__ float step_value(const RegularArgs& a, const float* row,
                                            const float* rraw, int j) {
    const float NaN = group_acc::nan_f();
    const float INF = group_acc::inf_f();
    const int func = a.func;
    const float count = __ldg(a.count + j);
    const bool has = count > 0.0f;
    const bool has2 = count >= 2.0f;
    if (func == COUNT_OVER_TIME) return has ? count : NaN;
    if (func == PRESENT_OVER_TIME) return has ? 1.0f : NaN;
    if (func == ABSENT_OVER_TIME) return has ? NaN : 1.0f;
    if (func >= CHANGES && func <= PREDICT_LINEAR) {
        if (!has) return NaN;
        const int lo = __ldg(a.lo + j), hi = __ldg(a.hi + j);
        if (func == CHANGES || func == RESETS) {
            // flagged pairs (t-1, t) with lo < t < hi, read from raw (the
            // differences of a diff-staged counter, else the values)
            const bool diffs = a.is_counter && !a.is_delta;
            float n = 0.0f;
            for (int t = lo + 1; t < hi; ++t) {
                const float x = rraw[t];
                const float ref = diffs ? 0.0f : rraw[t - 1];
                n += (func == CHANGES ? x != ref : x < ref) ? 1.0f : 0.0f;
            }
            return n;
        }
        if (func == MIN_OVER_TIME || func == MAX_OVER_TIME) {
            const bool is_min = func == MIN_OVER_TIME;
            float r = MINMAX_SENTINEL;
            for (int t = lo; t < hi; ++t) r = fminf(r, is_min ? row[t] : -row[t]);
            return is_min ? r : -r;
        }
        // least squares with time centred at the step (tc in s, rounded to
        // f32 once from f64, as the host's Wt)
        const double ot = __ldg(a.out_t64 + j);
        float sv = 0.0f, stv = 0.0f;
        for (int t = lo; t < hi; ++t) {
            const float v = row[t];
            const float tc = (float)(((double)__ldg(a.rts + t) - ot) * 1e-3);
            sv += v;
            stv += v * tc;
        }
        const float st = __ldg(a.st + j), stt = __ldg(a.stt + j);
        const float denom = count * stt - st * st;
        const bool small = fabsf(denom) < 1e-30f;
        const float slope = (count * stv - st * sv) / (small ? 1.0f : denom);
        if (!has2 || small) return NaN;
        if (func == DERIV) return slope;
        const float intercept = (sv - slope * st) / fmaxf(count, 1.0f);
        return intercept + slope * a.lead;
    }
    const int iF = __ldg(a.idx + j);
    const int iL = __ldg(a.idx + a.ld + j);
    const float w_s = a.window_ms * 1e-3f;
    const bool moments = func == STDDEV_OVER_TIME || func == STDVAR_OVER_TIME || func == Z_SCORE;
    if (is_win_sum(a) || moments) {
        if (!has) return NaN;
        const int lo = __ldg(a.lo + j), hi = __ldg(a.hi + j);
        // in index order, two samples per 8-byte load where aligned
        float sm = 0.0f, sm2 = 0.0f;
        int k = lo;
        if ((k & 1) && k < hi) {
            const float v = row[k++];
            sm += v;
            if (moments) sm2 += v * v;
        }
        for (; k + 1 < hi; k += 2) {
            const float2 v = *reinterpret_cast<const float2*>(row + k);
            sm += v.x;
            if (moments) sm2 += v.x * v.x;
            sm += v.y;
            if (moments) sm2 += v.y * v.y;
        }
        if (k < hi) {
            const float v = row[k];
            sm += v;
            if (moments) sm2 += v * v;
        }
        if (func == SUM_OVER_TIME || func == INCREASE) return sm;
        if (func == RATE) return sm / w_s;
        if (func == AVG_OVER_TIME) return sm / fmaxf(count, 1.0f);
        const float c = fmaxf(count, 1.0f);
        const float mean = sm / c;
        const float var = fmaxf(sm2 / c - mean * mean, 0.0f);
        const float sd = sqrtf(var);
        if (func == STDVAR_OVER_TIME) return var;
        if (func == STDDEV_OVER_TIME) return sd;
        return (row[iL] - mean) / fmaxf(sd, 1e-30f);
    }
    if (func == LAST) return has ? row[iL] : NaN;
    if (func == FIRST_OVER_TIME) return has ? row[iF] : NaN;
    if (!has2) return NaN;  // extrapolation, irate and idelta need two samples
    if (is_extrap(a)) {
        // per-step terms of the extrapolation (mxu_kernels.py:324-333, :343)
        const float tf = __ldg(a.tf + j) * 1e-3f;
        const float tl = __ldg(a.tl + j) * 1e-3f;
        const float out_t = __ldg(a.out_t + j);
        const float sampled = tl - tf;
        const float range_start = (out_t - a.window_ms) * 1e-3f;
        const float range_end = out_t * 1e-3f;
        const float dur_start = tf - range_start;
        const float dur_end = range_end - tl;
        const float avg_dur = sampled / fmaxf(count - 1.0f, 1.0f);
        const float thresh = avg_dur * 1.1f;
        const float de = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
        const float vf = row[iF];
        const float dlt = row[iL] - vf;
        float ds = dur_start;
        if (needs_raw(a)) {
            const float vfr = rraw[iF];
            const float dur_zero = dlt > 0.0f ? sampled * (vfr / fmaxf(dlt, 1e-30f)) : INF;
            ds = nan_min(dur_start, vfr >= 0.0f ? dur_zero : INF);
        }
        ds = ds >= thresh ? avg_dur / 2.0f : ds;
        const float factor = (sampled + ds + de) / fmaxf(sampled, 1e-30f);
        const float r = dlt * factor;
        return func == RATE ? r / w_s : r;
    }
    if (func == IDELTA && a.is_counter && !a.is_delta) return row[iL];  // diff-staged counter
    // irate, idelta
    const float dv = row[iL] - row[__ldg(a.idx + 2 * a.ld + j)];
    if (func == IDELTA) return dv;
    const float dt_s = (__ldg(a.tl + j) - __ldg(a.tl2 + j)) * 1e-3f;
    return dv / fmaxf(dt_s, 1e-30f);
}

template <bool SHARED, bool STORE>
__global__ void __launch_bounds__(THREADS) regular_range_kernel(const RegularArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int part = SHARED ? a.G * a.J : 0;
    float* acc_s = smem;
    float* cnt_s = smem + part;
    const int R = a.R;
    const group_acc::Sink sink = SHARED ? group_acc::Sink{acc_s, cnt_s, a.J, a.acc_op}
                                        : group_acc::Sink{a.acc, a.cnt, a.ld, a.acc_op};
    const group_acc::Store store{a.acc, a.S};
    if (SHARED) {
        group_acc::shared_init(acc_s, cnt_s, part, a.acc_op);
        __syncthreads();
    }
    row_tiles::for_each_tile<false>(a.S, R, [](int, int) {}, [&](int tile, int) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::for_each_pair(min(R, a.S - (int)s0), a.J, [&](int r, int j) {
            const int64_t s = s0 + r;
            const long long g = __ldg(a.gids + s);
            if (g < 0 || g >= a.G) {  // trash group G (padding) or no group
                if (STORE) store.put(s, j, group_acc::nan_f());
                return;
            }
            const float v = step_value(a, a.vals + s * a.T, a.raw + s * a.T, j);
            if (STORE) store.put(s, j, v);
            else if (!isnan(v)) sink.add(g, j, v);
        });
    });
    if (SHARED) {
        __syncthreads();
        group_acc::shared_flush(acc_s, cnt_s, a.G, a.J, a.acc, a.cnt, a.ld, a.acc_op);
    }
}

template <bool SHARED, bool STORE = false>
int launch(const RegularArgs& a, int smem, cudaStream_t stream) {
    auto kern = regular_range_kernel<SHARED, STORE>;
    int grid = 0;
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, (a.S + a.R - 1) / a.R, &grid);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. acc [G+1, ld] must hold the accumulator's
// identity (0, +inf or -inf) and cnt [G+1, ld] zeros; steps [0, J) are
// computed. `rows` rows per tile; `shared` keeps the group partials in
// shared memory; `smem_bytes` is the dynamic shared memory the wrapper
// sized for them (checked here). acc_op ACC_STORE is the store mode: acc
// is the [ld, S] grid, cnt is not read, `shared` must be 0. Launches on
// `stream` and returns a cudaError_t (0 on success); it does not
// synchronise.
extern "C" int filodb_regular_range(
    const void* vals, const void* raw, const void* gids, const void* lo,
    const void* hi, const void* idx, const void* count, const void* t_first, const void* t_last,
    const void* t_last2, const void* out_t, const void* rts, const void* out_t64,
    const void* st, const void* stt, int S, int T, int J, int ld, int G,
    float window_ms, float lead, int func, int acc_op, int is_counter, int is_delta, int rows,
    int shared, int smem_bytes, void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0) return 0;
    if ((func == DERIV || func == PREDICT_LINEAR) && (!rts || !out_t64 || !st || !stt))
        return (int)cudaErrorInvalidValue;
    RegularArgs a{(const float*)vals, (const float*)raw, (const long long*)gids,
                  (const int32_t*)lo, (const int32_t*)hi, (const int32_t*)idx,
                  (const float*)count, (const float*)t_first, (const float*)t_last,
                  (const float*)t_last2, (const float*)out_t, (const int32_t*)rts,
                  (const double*)out_t64, (const float*)st, (const float*)stt, S, T, J, ld, G,
                  window_ms, lead, func, acc_op, is_counter, is_delta, rows, (float*)acc,
                  (float*)cnt};
    const int64_t part = shared ? (((int64_t)2 * G * J + 3) & ~3) * 4 : 0;
    const bool store = acc_op == group_acc::ACC_STORE;
    if (rows < 1 || smem_bytes < part || (store && shared)) return (int)cudaErrorInvalidValue;
    cudaStream_t strm = (cudaStream_t)stream;
    if (store) return launch<false, true>(a, smem_bytes, strm);
    return shared ? launch<true>(a, smem_bytes, strm) : launch<false>(a, smem_bytes, strm);
}

// Lane mode (B12: the cross-query batched program _batched_mxu_jit,
// filodb_tpu/ops/aggregations.py:1233, which runs mxu_range_kernel once per
// unique window and _apply_epilogue once per lane). One launch over U
// unique windows (blockIdx.y = u) serves L lanes: the window tables are
// stacked [U, ld] ([U, 3, ld] for idx) with window_ms [U]; a block
// computes each (row, step) value of window u once (step_value, the solo
// kernel's function) and folds it into every lane of u at the lane's
// group (group_acc.cuh lanes::). STORE: the [U, ld, S] store grids of the
// fused epilogues, one per unique window, rows outside the group of
// gids[0] NaN. Bound: the sectors of vals (and raw) each window reads, U
// times, plus L * S * 4 bytes of gids and the [L, G, J] outputs; the
// lanes' group atomics grow with L, which shared partials absorb while
// they fit.
namespace {

template <bool SHARED, bool STORE>
__global__ void __launch_bounds__(THREADS) regular_lanes_kernel(const RegularArgs a0,
                                                                const lanes::Table t,
                                                                const float* window_ms) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int lane_s[lanes::MAX_LANES];
    __shared__ int nl_s;
    const int u = blockIdx.y;
    RegularArgs a = a0;  // window u's tables
    const int64_t wo = (int64_t)u * a.ld;
    a.lo += wo;
    a.hi += wo;
    a.count += wo;
    a.tf += wo;
    a.tl += wo;
    a.tl2 += wo;
    a.out_t += wo;
    a.idx += 3 * wo;
    a.window_ms = __ldg(window_ms + u);
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
    const group_acc::Store store{a.acc + wo * a.S, a.S};
    const int R = a.R;
    row_tiles::for_each_tile<false>(a.S, R, [](int, int) {}, [&](int tile, int) {
        const int64_t s0 = (int64_t)tile * R;
        row_tiles::for_each_pair(min(R, a.S - (int)s0), a.J, [&](int r, int j) {
            const int64_t s = s0 + r;
            if (s >= a.S) return;
            if (STORE) {
                const int g = __ldg(t.gids + s);
                store.put(s, j, g < 0 || g >= t.G
                                    ? group_acc::nan_f()
                                    : step_value(a, a.vals + s * a.T, a.raw + s * a.T, j));
                return;
            }
            if (!lanes::wants(t, lane_s, nl, s)) return;
            const float v = step_value(a, a.vals + s * a.T, a.raw + s * a.T, j);
            if (!isnan(v)) lanes::add<SHARED>(t, lane_s, nl, smem, a.J, s, j, v);
        });
    });
    if (SHARED) {
        __syncthreads();
        lanes::flush(t, lane_s, nl, smem, a.J, 0);
    }
}

template <bool SHARED, bool STORE>
int launch_lanes(const RegularArgs& a, const lanes::Table& t, const float* window_ms, int U,
                 int smem, cudaStream_t stream) {
    auto kern = regular_lanes_kernel<SHARED, STORE>;
    int resident = 0;  // also raises the kernel's shared-memory allowance to smem
    const cudaError_t err = row_tiles::persistent_grid(kern, smem, 1 << 30, &resident);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (a.S + a.R - 1) / a.R;
    const int grid = max(1, min(tiles, resident / U));
    kern<<<dim3(grid, U), THREADS, smem, stream>>>(a, t, window_ms);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: the lane mode. lo, hi, count, t_first, t_last,
// t_last2, out_t are [U, ld] (idx [U, 3, ld]) and window_ms [U] f32, one
// row per unique window; gids [L, S] int32 and u_of_lane [L] int32 (L <=
// lanes::MAX_LANES); acc and cnt [L, G+1, ld] at the op's identity and
// zero. `shared` keeps every lane's partials in shared memory, sized by
// the wrapper for `lanes_max` lanes of one window (`smem_bytes`, checked
// here). acc_op ACC_STORE: acc is the [U, ld, S] grids, gids [1, S] (rows
// outside [0, G) NaN), cnt and u_of_lane unread, `shared` 0. Steps [0, J)
// are computed. Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_regular_range_lanes(
    const void* vals, const void* raw, const void* lo, const void* hi, const void* idx,
    const void* count, const void* t_first, const void* t_last, const void* t_last2,
    const void* out_t, const void* window_ms, int S, int T, int J, int ld, int U,
    const void* gids, const void* u_of_lane, int L, int G, int func, int acc_op,
    int is_counter, int is_delta, int rows, int shared, int lanes_max, int smem_bytes,
    void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || U <= 0 || L <= 0) return 0;
    const bool store = acc_op == group_acc::ACC_STORE;
    const int64_t part = shared ? (((int64_t)2 * lanes_max * G * J + 3) & ~3) * 4 : 0;
    if (func == DERIV || func == PREDICT_LINEAR || rows < 1 || ld < J || U > 65535 ||
        L > lanes::MAX_LANES || lanes_max < 1 || lanes_max > L || smem_bytes < part ||
        (store && shared) || !window_ms || !gids || (!store && !u_of_lane))
        return (int)cudaErrorInvalidValue;
    RegularArgs a{(const float*)vals, (const float*)raw, nullptr, (const int32_t*)lo,
                  (const int32_t*)hi, (const int32_t*)idx, (const float*)count,
                  (const float*)t_first, (const float*)t_last, (const float*)t_last2,
                  (const float*)out_t, nullptr, nullptr, nullptr, nullptr, S, T, J, ld, G,
                  0.0f, 0.0f, func, acc_op, is_counter, is_delta, rows, (float*)acc,
                  (float*)cnt};
    const lanes::Table t{(const int32_t*)gids, (const int32_t*)u_of_lane, L, S, G,
                         (int64_t)(G + 1) * ld, ld, acc_op, (float*)acc, (float*)cnt};
    const float* w = (const float*)window_ms;
    cudaStream_t strm = (cudaStream_t)stream;
    if (store) return launch_lanes<false, true>(a, t, w, U, smem_bytes, strm);
    return shared ? launch_lanes<true, false>(a, t, w, U, smem_bytes, strm)
                  : launch_lanes<false, false>(a, t, w, U, smem_bytes, strm);
}
