// Native-histogram range functions fused with the per-bucket group sum,
// and the histogram_quantile epilogue, on Hopper (sm_90a).
//
// 1. hist_range_kernel (entry filodb_hist_range_aggregate) replaces the
//    two XLA programs that filodb_tpu/ops/hist_kernels.py runs behind one
//    jit: the per-bucket range function -- hist_range_kernel (:29, window
//    bounds searched per series) or _hist_range_shared (:157, the [J]
//    bounds of a shared regular grid) -- and _segment_aggregate_jit "sum"
//    over the flattened [S, J*B] grid, as _fused_hist_jit (:351) and
//    _fused_hist_shared_jit (:329) compose them. For every (row s, step
//    j < J, bucket b) it computes rate / increase / delta (Prometheus
//    extrapolation, no zero cap), sum_over_time (and rate / increase of a
//    delta column) as the window sum, or last, and reduces it straight into
//    [G, J*B] group accumulators acc (the sum) and cnt (valid members); no
//    [S, J, B] plane reaches device memory.
// 2. hist_quantile_kernel (entry filodb_hist_quantile) replaces
//    histogram_quantile (:86) in the quantile epilogue: it finishes the
//    group partials (a bucket with no member is NaN) and interpolates
//    Prometheus' histogram_quantile over the bucket axis, one thread per
//    (group, step).
//
// Design of hist_range_kernel. A sample's B buckets are contiguous
// ([S, T, B]), so each thread owns one column c = j * B + b of the
// flattened (step, bucket) axis -- the 256 threads of a block take 256
// neighbouring columns, and neighbouring lanes read neighbouring buckets
// of one sample, then the next step's -- and walks a chunk of rows
// (blockIdx.y), keeping a running sum of its column while consecutive rows
// share a group. A run is folded into the group partials when the group
// changes and at the chunk's end: shared-memory [G, 256] partials flushed
// once per block when 2*G*256*4 bytes fit the wrapper's budget, else
// global atomics. With shared bounds the window [lo, hi) and the
// extrapolation factor of a column are the same in every row, so a
// thread computes them once; with per-series bounds each row's window is
// searched in its ts row (window_search.cuh), the 12 lanes of one step
// reading the same entries.
//
// Bound of hist_range_kernel: device-memory bytes. For rate, increase and
// delta, each real row's buckets at the distinct first and last samples
// of the query's windows (bench.py's 100k-series store: 222 samples x 12
// buckets x 4 bytes per row, 1,065,600,000 bytes, 0.32 ms at 3.35 TB/s),
// gids and the outputs; a few dozen flops per (row, step, bucket).
//
// Semantics kept from the JAX package: f32 extrapolation with the 1.1 x
// average-duration rule and no zero cap; NaN where a window holds fewer
// than two samples (rate family) or none; window sums taken in index order
// inside the window (the JAX package takes a difference of f32 prefix
// sums, which rounds differently: the tests hold the two at rtol 2e-4);
// padded rows (group G) skipped; a NaN value is absence. The build passes
// -fmad=false so that each f32 multiply and add rounds separately, as in
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_acc.cuh"
#include "window_search.cuh"

namespace {

using window_search::count_le;
using window_search::lower_edge;
using window_search::wrap_add;
using window_search::wrap_mul;

constexpr int THREADS = 256;  // columns per block of hist_range_kernel

// range functions (ops/hist_kernels.py HIST_FUNC_CODES)
enum HFunc { H_RATE = 0, H_INCREASE, H_DELTA, H_SUM_OVER_TIME, H_LAST };

struct HistArgs {
    const int32_t* ts;       // [S, T] (per-series bounds)
    const float* vals;       // [S, T, B]
    const int32_t* lens;     // [S] (per-series bounds)
    const long long* gids;   // [S]
    const int32_t* lo;       // [J] shared bounds: window [lo, hi) of each step
    const int32_t* hi;
    const int32_t* t_first;  // [J] shared bounds: the window's first/last timestamps
    const int32_t* t_last;
    int S, T, B, J, ld, G;
    int32_t start, step, window;
    int func, is_delta;
    int rows;  // rows per block (blockIdx.y walks chunks of them)
    float* acc;
    float* cnt;
};

// hist_kernels.py:59-77 / :185-200: Prometheus' extrapolation factor of a
// window of cnt samples whose first and last timestamps are tf and tl
__device__ __forceinline__ float extrap_factor(int cnt_i, int32_t tf_i, int32_t tl_i,
                                               int32_t t_j, int32_t window) {
    const float cnt = (float)cnt_i;
    const float tf = (float)tf_i * 1e-3f;
    const float tl = (float)tl_i * 1e-3f;
    const float sampled = tl - tf;
    const float range_start = (float)wrap_add(t_j, -window) * 1e-3f;
    const float range_end = (float)t_j * 1e-3f;
    float dur_start = tf - range_start;
    float dur_end = range_end - tl;
    const float avg_dur = sampled / fmaxf(cnt - 1.0f, 1.0f);
    const float thresh = avg_dur * 1.1f;
    dur_start = dur_start >= thresh ? avg_dur / 2.0f : dur_start;
    dur_end = dur_end >= thresh ? avg_dur / 2.0f : dur_end;
    return (sampled + dur_start + dur_end) / fmaxf(sampled, 1e-30f);
}

// fold a run of n values summing to v into group g's partial of column col
__device__ __forceinline__ void fold_run(float* acc, float* cnt, int64_t ld, long long g,
                                         int col, float v, float n) {
    const int64_t i = g * ld + col;
    group_acc::fold(acc + i, cnt + i, group_acc::ACC_ADD, v, n);
}

template <bool SHARED_BOUNDS, bool SHARED>
__global__ void __launch_bounds__(THREADS) hist_range_kernel(const HistArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int part = SHARED ? a.G * THREADS : 0;
    float* acc_s = smem;
    float* cnt_s = smem + part;
    if (SHARED) {
        group_acc::shared_init(acc_s, cnt_s, part, group_acc::ACC_ADD);
        __syncthreads();
    }
    const int c0 = blockIdx.x * THREADS;
    const int c = c0 + threadIdx.x;
    if (c < a.J * a.B) {
        const float NaN = group_acc::nan_f();
        const int B = a.B;
        const int j = c / B, b = c - j * B;
        const int32_t t_j = wrap_add(a.start, wrap_mul(j, a.step));
        const float w_s = (float)a.window * 1e-3f;
        const bool win_sum =
            a.func == H_SUM_OVER_TIME || (a.is_delta && (a.func == H_RATE || a.func == H_INCREASE));
        const bool extrap = !win_sum && a.func != H_LAST;
        int lo = 0, hi = 0;
        float factor = 0.0f;
        if (SHARED_BOUNDS) {  // the same window in every row
            lo = __ldg(a.lo + j);
            hi = __ldg(a.hi + j);
            if (extrap && hi - lo >= 2)
                factor = extrap_factor(hi - lo, __ldg(a.t_first + j), __ldg(a.t_last + j), t_j,
                                       a.window);
        }
        const int64_t r0 = (int64_t)blockIdx.y * a.rows;
        const int64_t r1 = r0 + a.rows < a.S ? r0 + a.rows : (int64_t)a.S;
        long long g_run = -1;
        float sum = 0.0f, n_run = 0.0f;
        for (int64_t s = r0; s < r1; ++s) {
            const long long g = __ldg(a.gids + s);
            if (g < 0 || g >= a.G) continue;  // trash group G (padding) or no group
            if (!SHARED_BOUNDS) {
                const int32_t* rt = a.ts + s * a.T;
                const int n = min(max(__ldg(a.lens + s), 0), a.T);
                hi = count_le<true>(rt, n, t_j);
                lo = lower_edge(rt, hi, wrap_add(t_j, -a.window));
                if (extrap && hi - lo >= 2)
                    factor = extrap_factor(hi - lo, __ldg(rt + lo), __ldg(rt + hi - 1), t_j,
                                           a.window);
            }
            // this row's bucket b, one sample every B floats
            const float* row = a.vals + s * a.T * B + b;
            float v;
            if (a.func == H_LAST) {
                v = hi > lo ? __ldg(row + (int64_t)(hi - 1) * B) : NaN;
            } else if (win_sum) {
                float sm = 0.0f;
                for (int k = lo; k < hi; ++k) sm += __ldg(row + (int64_t)k * B);
                if (a.func == H_RATE) sm = sm / w_s;
                v = hi > lo ? sm : NaN;
            } else {
                v = NaN;
                if (hi - lo >= 2) {
                    const float dlt =
                        __ldg(row + (int64_t)(hi - 1) * B) - __ldg(row + (int64_t)lo * B);
                    const float r = dlt * factor;
                    v = a.func == H_RATE ? r / w_s : r;
                }
            }
            if (isnan(v)) continue;
            if (g != g_run) {
                if (n_run > 0.0f) {
                    if (SHARED) fold_run(acc_s, cnt_s, THREADS, g_run, threadIdx.x, sum, n_run);
                    else fold_run(a.acc, a.cnt, a.ld, g_run, c, sum, n_run);
                }
                g_run = g;
                sum = 0.0f;
                n_run = 0.0f;
            }
            sum += v;
            n_run += 1.0f;
        }
        if (n_run > 0.0f) {
            if (SHARED) fold_run(acc_s, cnt_s, THREADS, g_run, threadIdx.x, sum, n_run);
            else fold_run(a.acc, a.cnt, a.ld, g_run, c, sum, n_run);
        }
    }
    if (SHARED) {
        __syncthreads();
        // the block's [G, 256] partials are its columns c0 .. c0+255 of the
        // global [G+1, ld] arrays; columns past J*B received nothing
        group_acc::shared_flush(acc_s, cnt_s, a.G, THREADS, a.acc + c0, a.cnt + c0, a.ld,
                                group_acc::ACC_ADD);
    }
}

template <bool SHARED_BOUNDS, bool SHARED>
int launch_range(const HistArgs& a, int smem, cudaStream_t stream) {
    auto kern = hist_range_kernel<SHARED_BOUNDS, SHARED>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((a.J * a.B + THREADS - 1) / THREADS, (a.S + a.rows - 1) / a.rows);
    kern<<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

__global__ void hist_quantile_kernel(const float* __restrict__ acc, const float* __restrict__ cnt,
                                     const float* __restrict__ les, int G, int J, int B, int ld,
                                     int ld_out, float q, float* __restrict__ out) {
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (int64_t)G * J) return;
    const int g = (int)(idx / J);
    const int j = (int)(idx - (int64_t)g * J);
    const float NaN = group_acc::nan_f();
    const float INF = group_acc::inf_f();
    const float* ar = acc + (int64_t)g * ld + (int64_t)j * B;
    const float* cr = cnt + (int64_t)g * ld + (int64_t)j * B;
    // the finished group sum of bucket i: NaN where no member had a value
    auto bucket = [&](int i) { return cr[i] > 0.0f ? ar[i] : NaN; };
    const float total = bucket(B - 1);
    const bool ok = total > 0.0f && isfinite(total);
    const float rank = fminf(fmaxf(q, 0.0f), 1.0f) * total;
    int k = B - 1;  // the first bucket whose count reaches the rank
    for (int i = 0; i < B; ++i) {
        if (bucket(i) >= rank) {
            k = i;
            break;
        }
    }
    const float c_hi = bucket(k);
    const float c_lo = k > 0 ? bucket(k - 1) : 0.0f;
    const float le_hi = les[k];
    const float le_lo = k > 0 ? les[k - 1] : (les[0] > 0.0f ? 0.0f : -INF);
    const float highest_finite = B >= 2 ? les[B - 2] : les[0];
    const float denom = c_hi - c_lo;
    const float frac = (rank - c_lo) / (isnan(denom) ? denom : fmaxf(denom, 1e-30f));
    float val = le_lo + (le_hi - le_lo) * frac;
    if (k == B - 1) val = highest_finite;  // the +Inf bucket: the highest finite bound
    if (isinf(le_lo) && le_lo < 0.0f) val = le_hi;  // les[0] <= 0
    float res = ok ? val : NaN;
    if (q < 0.0f) res = -INF;
    if (q > 1.0f) res = INF;
    out[(int64_t)g * ld_out + j] = res;
}

}  // namespace

// Plain C entry for ctypes: sum by (...) (func(m[w])) over a [S, T, B]
// histogram block. acc and cnt [G+1, ld] (ld >= J * B) must hold zeros;
// columns j * B + b of steps [0, J) are computed. shared_bounds: the [J]
// arrays lo, hi, t_first, t_last give every row's window (a regular grid);
// else each row's window is searched in ts [S, T] over lens. `rows` rows
// per block; `shared` keeps [G, 256] partials in shared memory;
// `smem_bytes` is the dynamic shared memory the wrapper sized for them
// (checked here). Launches on `stream` and returns a cudaError_t (0 on
// success); it does not synchronise.
extern "C" int filodb_hist_range_aggregate(
    const void* ts, const void* vals, const void* lens, const void* gids, const void* lo,
    const void* hi, const void* t_first, const void* t_last, int S, int T, int B, int J, int ld,
    int G, int start, int step, int window, int func, int is_delta, int shared_bounds, int rows,
    int shared, int smem_bytes, void* acc, void* cnt, void* stream) {
    if (S <= 0 || J <= 0 || G <= 0 || B <= 0) return 0;
    const int64_t part = shared ? (int64_t)2 * G * THREADS * 4 : 0;
    const bool bounds_ok = shared_bounds ? (lo && hi && t_first && t_last) : (ts && lens);
    if (func < H_RATE || func > H_LAST || rows < 1 || (int64_t)(S + rows - 1) / rows > 65535 ||
        ld < J * B || smem_bytes < part || !bounds_ok)
        return (int)cudaErrorInvalidValue;
    HistArgs a{(const int32_t*)ts, (const float*)vals, (const int32_t*)lens,
               (const long long*)gids, (const int32_t*)lo, (const int32_t*)hi,
               (const int32_t*)t_first, (const int32_t*)t_last, S, T, B, J, ld, G,
               (int32_t)start, (int32_t)step, (int32_t)window, func, is_delta, rows,
               (float*)acc, (float*)cnt};
    cudaStream_t st = (cudaStream_t)stream;
    if (shared_bounds)
        return shared ? launch_range<true, true>(a, smem_bytes, st)
                      : launch_range<true, false>(a, smem_bytes, st);
    return shared ? launch_range<false, true>(a, smem_bytes, st)
                  : launch_range<false, false>(a, smem_bytes, st);
}

// Plain C entry for ctypes: histogram_quantile(q, .) of the group sums in
// acc/cnt [G+1, ld] (bucket b of step j at column j * B + b) over the
// bounds les [B] (les[B-1] = +inf), into out [G, ld_out] at steps [0, J).
// Launches on `stream` and returns a cudaError_t (0 on success); it does
// not synchronise.
extern "C" int filodb_hist_quantile(const void* acc, const void* cnt, const void* les, int G,
                                    int J, int B, int ld, int ld_out, float q, void* out,
                                    void* stream) {
    if (G <= 0 || J <= 0) return 0;
    if (B < 1 || ld < J * B || ld_out < J) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int64_t blocks = ((int64_t)G * J + threads - 1) / threads;
    hist_quantile_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)acc, (const float*)cnt, (const float*)les, G, J, B, ld, ld_out, q,
        (float*)out);
    return (int)cudaGetLastError();
}
