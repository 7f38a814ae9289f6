// Window statistics for irregular series on Hopper (sm_90a).
//
// Replaces the TPU kernel filodb_tpu/ops/pallas_kernels.py:33
// (_window_agg_kernel, launched by window_aggregates). For every series row
// s and output step j, over the window (t_j - w, t_j] with
// t_j = start + j * step, it writes nine f32 planes [S, J]: count, sum,
// min, max, first/last timestamp, first/last value and the first raw value.
//
// Design. The TPU kernel scans all T samples of a 64-row tile for each of
// 128 steps and accumulates one-hot columns in VMEM. Here rows are sorted
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
// as long as a row's window span stays resident; a sliding-window or
// shared-memory-tiled variant is later work.
//
// Semantics kept from the TPU kernel: time math in int32 with wrap-around,
// first/last timestamps selected as int32 and cast to f32 at the store,
// NaN values confined to the windows that hold them (per-window
// accumulation), and the empty-window sentinels below. First/last are
// picked by index, which agrees with the TPU kernel's pick-by-timestamp for
// strictly increasing timestamps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float POS = 3.0e38f;
constexpr float NEG = -3.0e38f;
constexpr int32_t IMAX = 2147483647;
constexpr int32_t IMIN = -2147483647;

// int32 add/multiply with two's-complement wrap (as jnp.int32 does)
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

// number of entries in row[0, n) that are <= x (row sorted ascending)
__device__ __forceinline__ int count_le(const int32_t* __restrict__ row, int n, int32_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (__ldg(row + mid) <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

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
    int hi = count_le(row_t, n, t_j);
    int lo = count_le(row_t, n, t_lo);
    if (lo > hi) lo = hi;  // empty window (w <= 0 or wrapped bounds)

    float sum = 0.0f, mn = POS, mx = NEG;
    for (int k = lo; k < hi; ++k) {
        float v = __ldg(row_v + k);
        sum += v;
        // NaN propagates as in jnp.min / jnp.max
        mn = (isnan(v) || v < mn) ? v : mn;
        mx = (isnan(v) || v > mx) ? v : mx;
    }
    bool has = hi > lo;
    cnt_o[idx] = (float)(hi - lo);
    sum_o[idx] = sum;
    min_o[idx] = mn;
    max_o[idx] = mx;
    tf_o[idx] = (float)(has ? __ldg(row_t + lo) : IMAX);
    tl_o[idx] = (float)(has ? __ldg(row_t + hi - 1) : IMIN);
    vf_o[idx] = has ? __ldg(row_v + lo) : 0.0f;
    vl_o[idx] = has ? __ldg(row_v + hi - 1) : 0.0f;
    rf_o[idx] = has ? __ldg(row_r + lo) : 0.0f;
}

}  // namespace

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
